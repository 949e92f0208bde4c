"""Host-side batch processors of the port: mask generators, transforms and
tokenizers."""

from mmlearn_tpu_torch.datasets.processors.masking import (
    BlockwiseImagePatchMaskGenerator,
    IJEPAMaskGenerator,
    RandomMaskGenerator,
)
from mmlearn_tpu_torch.datasets.processors.tokenizers import HFCLIPTokenizer, HFTokenizer, Img2Seq
from mmlearn_tpu_torch.datasets.processors.transforms import (
    CLIP_MEAN,
    CLIP_STD,
    TrimText,
    center_crop,
    normalize_image,
    pad_or_trim,
    resize_image,
)

__all__ = [
    "BlockwiseImagePatchMaskGenerator",
    "CLIP_MEAN",
    "CLIP_STD",
    "HFCLIPTokenizer",
    "HFTokenizer",
    "IJEPAMaskGenerator",
    "Img2Seq",
    "RandomMaskGenerator",
    "TrimText",
    "center_crop",
    "normalize_image",
    "pad_or_trim",
    "resize_image",
]
