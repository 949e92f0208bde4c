"""The med_benchmarking datasets' registrations and their transform,
counterpart of ``projects.med_benchmarking.datasets``: importing it puts
the 13 readers in the ``datasets`` group and ``med_clip_vision_transform``
in ``datasets/transforms``."""

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.datasets.builtin.image_utils import CLIP_MEAN, CLIP_STD, ImageTransform
from mmlearn_tpu_torch.projects.med_benchmarking.datasets.classification import (
    BACH,
    HAM10000,
    LC25000,
    PCAM,
    SICAP,
    MedMNISTPlus,
    NckCrc,
    PadUfes20,
)
from mmlearn_tpu_torch.projects.med_benchmarking.datasets.image_text import (
    MIMICIVCXR,
    PMCOA,
    ROCO,
    MedVQA,
    Quilt,
)


@external_store(group="datasets/transforms", name="med_clip_vision_transform",
                populate_full_signature=False)
def med_clip_vision_transform(image_crop_size: int = 224,
                              job_type: str = "train") -> ImageTransform:
    """CLIP's statistics; the random crop and flip when ``job_type`` is
    ``train``, else the resize and centre crop."""
    return ImageTransform(size=image_crop_size, mean=CLIP_MEAN, std=CLIP_STD,
                          train=(job_type == "train"))


__all__ = [
    "BACH",
    "HAM10000",
    "LC25000",
    "MIMICIVCXR",
    "MedMNISTPlus",
    "MedVQA",
    "NckCrc",
    "PCAM",
    "PMCOA",
    "PadUfes20",
    "Quilt",
    "ROCO",
    "SICAP",
    "med_clip_vision_transform",
]
