"""Host-side image loading and transforms for the port's readers, a
counterpart of :mod:`mmlearn_tpu.datasets.builtin.image_utils` (the CLIP
and ImageNet constants, ``load_image`` :23, ``decode_transform_jpeg`` :32,
``to_model_dtype`` :74, ``ImageTransform`` :89): fixed-shape HWC arrays,
float32 normalized on the host or uint8 for the trainer's
``device_normalize``.

Two departures from the JAX package. A failed native build (no compiler,
no libjpeg) raises instead of falling back to PIL; only a JPEG that libjpeg
cannot decode (a CMYK file, say) is retried with PIL, and only where PIL is
installed: elsewhere it raises, never yielding a zero image. The array path
of :class:`ImageTransform` (bicubic resizes) needs PIL, as in the JAX
package.
"""

from __future__ import annotations

import importlib.util
import io
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from mmlearn_tpu_torch.conf import store

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_image(path: str, mode: str = "RGB") -> np.ndarray:
    """Load an image file as HWC uint8 (or HW for depth/grayscale modes)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert(mode) if mode else img
        return np.asarray(img)


def decode_transform_jpeg(
    data: bytes, transform: "ImageTransform",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Decode JPEG bytes and apply ``transform`` in the native fastloader:
    eval, the fused decode + resize + centre crop; train, the fused decode +
    random-resized crop + flip, its seed drawn from ``rng``. A JPEG the
    native decoder rejects goes through PIL and ``transform`` where PIL is
    installed, else raises ``ValueError``."""
    from mmlearn_tpu_torch import native

    try:
        if transform.train:
            seed_rng = rng or np.random.default_rng()
            arr = native.decode_jpeg_train(
                data,
                transform.size,
                scale=tuple(transform.random_crop_scale),
                hflip_prob=transform.hflip_prob,
                seed=int(seed_rng.integers(0, 2**63 - 1)),
            )
        else:
            arr = native.decode_jpeg(data, transform.size)
    except ValueError as err:
        if importlib.util.find_spec("PIL") is None:
            raise ValueError(f"the native decoder rejected a JPEG of {len(data):,} bytes "
                             f"({err}) and PIL, the retry, is not installed") from None
        from PIL import Image

        with Image.open(io.BytesIO(data)) as img:
            return transform(np.asarray(img.convert("RGB")), rng=rng)
    if transform.device_normalize:
        return arr  # uint8; the trainer normalizes on the device
    out = arr.astype(np.float32) / 255.0
    return (out - np.asarray(transform.mean, np.float32)) / np.asarray(
        transform.std, np.float32
    )


def to_model_dtype(img: np.ndarray) -> np.ndarray:
    """float32 for host-normalized images; uint8 passes through untouched
    (``ImageTransform(device_normalize=True)`` emits uint8 for the
    trainer's normalization on the device)."""
    if img.dtype == np.uint8:
        return img
    return img.astype(np.float32)


@store(group="datasets/transforms", name="ImageTransform", populate_full_signature=False)
@dataclass
class ImageTransform:
    """Resize(+crop) -> scale to [0,1] -> normalize; train adds a random
    crop and flip. The array path uses PIL's bicubic resize."""

    size: int = 224
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD
    train: bool = False
    random_crop_scale: tuple[float, float] = (0.6, 1.0)
    hflip_prob: float = 0.5
    #: emit uint8 pixels and leave (x/255 - mean)/std to the device (the
    #: trainer's device_normalize; 4x smaller host->device transfer)
    device_normalize: bool = False

    def __call__(
        self, img: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        from PIL import Image

        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        pil = Image.fromarray(img.astype(np.uint8))
        if self.train:
            rng = rng or np.random.default_rng()
            w, h = pil.size
            scale = rng.uniform(*self.random_crop_scale)
            cw, ch = int(w * np.sqrt(scale)), int(h * np.sqrt(scale))
            left = rng.integers(0, max(1, w - cw + 1))
            top = rng.integers(0, max(1, h - ch + 1))
            pil = pil.crop((left, top, left + cw, top + ch)).resize(
                (self.size, self.size), Image.BICUBIC
            )
            if rng.random() < self.hflip_prob:
                pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            w, h = pil.size
            short = min(w, h)
            nw, nh = int(round(w * self.size / short)), int(round(h * self.size / short))
            pil = pil.resize((nw, nh), Image.BICUBIC)
            left = (nw - self.size) // 2
            top = (nh - self.size) // 2
            pil = pil.crop((left, top, left + self.size, top + self.size))
        if self.device_normalize:
            return np.asarray(pil, np.uint8)
        out = np.asarray(pil, np.float32) / 255.0
        return (out - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32
        )
