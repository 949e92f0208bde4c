"""I-JEPA project configs, counterpart of ``projects.ijepa.configs``: the
``ijepa_transforms`` train pipeline (crop, flip, colour distortion, blur) on
the host in PIL and numpy, registered in the store;
``experiment/in1k_vit_small.yaml`` is found through the searchpath
``pkg://mmlearn_tpu_torch.projects.ijepa.configs``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageTransform,
)


@external_store(group="datasets/transforms", name="ijepa_transforms",
                populate_full_signature=False)
@dataclass
class IJEPATransforms:
    """Random-resized-crop + flip + optional color distortion + blur."""

    crop_size: int = 224
    crop_scale: tuple[float, float] = (0.3, 1.0)
    color_jitter_strength: float = 0.0
    horizontal_flip: bool = True
    color_distortion: bool = False
    gaussian_blur: bool = False

    def __post_init__(self) -> None:
        self._base = ImageTransform(
            size=self.crop_size,
            mean=IMAGENET_MEAN,
            std=IMAGENET_STD,
            train=True,
            random_crop_scale=self.crop_scale,
            hflip_prob=0.5 if self.horizontal_flip else 0.0,
        )

    def __call__(
        self, img: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if self.color_distortion and self.color_jitter_strength > 0:
            s = self.color_jitter_strength
            img = img.astype(np.float32)
            img = img * rng.uniform(1 - 0.8 * s, 1 + 0.8 * s)  # brightness
            mean = img.mean(axis=(0, 1), keepdims=True)
            img = (img - mean) * rng.uniform(1 - 0.8 * s, 1 + 0.8 * s) + mean
            img = np.clip(img, 0, 255)
        if self.gaussian_blur and rng.random() < 0.5:
            import cv2

            sigma = rng.uniform(0.1, 2.0)
            img = cv2.GaussianBlur(np.asarray(img, np.float32), (0, 0), sigma)
        return self._base(np.asarray(img, np.float32), rng=rng)
