"""Built-in datasets of the port: the readers of files on disk (ImageNet,
CheXpert, NIHCXR, LLVIP, LibriSpeech, NYUv2, SUNRGBD), the image
transform, and the synthetic datasets."""

from mmlearn_tpu_torch.datasets.builtin.chexpert import CheXpert
from mmlearn_tpu_torch.datasets.builtin.image_utils import ImageTransform
from mmlearn_tpu_torch.datasets.builtin.imagenet import ImageNet
from mmlearn_tpu_torch.datasets.builtin.librispeech import LibriSpeech
from mmlearn_tpu_torch.datasets.builtin.llvip import LLVIP
from mmlearn_tpu_torch.datasets.builtin.nihcxr import NIHCXR
from mmlearn_tpu_torch.datasets.builtin.nyuv2 import NYUv2
from mmlearn_tpu_torch.datasets.builtin.sunrgbd import SUNRGBD
from mmlearn_tpu_torch.datasets.builtin.synthetic import SyntheticImages, SyntheticImageText

__all__ = [
    "CheXpert",
    "ImageNet",
    "ImageTransform",
    "LLVIP",
    "LibriSpeech",
    "NIHCXR",
    "NYUv2",
    "SUNRGBD",
    "SyntheticImageText",
    "SyntheticImages",
]
