"""Text and image transforms in numpy, counterpart of
:mod:`mmlearn_tpu.datasets.processors.transforms` (``TrimText`` :21,
``normalize_image`` :32, ``resize_image`` :42, ``center_crop`` :71,
``pad_or_trim`` :78).

``CLIP_MEAN`` and ``CLIP_STD`` are the CLIP channel statistics (the JAX
package keeps them in ``datasets/builtin/image_utils.py``); the trainer's
``device_normalize`` takes them for uint8 images normalized on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from mmlearn_tpu_torch.conf import store

#: CLIP's per-channel mean and standard deviation of RGB values in [0, 1]
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@store(group="datasets/transforms", name="TrimText", populate_full_signature=False)
@dataclass
class TrimText:
    """Trim text to ``trim_size`` characters."""

    trim_size: int = 512

    def __call__(self, sentence: str | Sequence[str]) -> str | list[str]:
        if isinstance(sentence, str):
            return sentence[: self.trim_size]
        return [s[: self.trim_size] for s in sentence]


def normalize_image(
    img: np.ndarray, mean: Sequence[float] = CLIP_MEAN, std: Sequence[float] = CLIP_STD
) -> np.ndarray:
    """Normalize a float HWC image with channel statistics (CLIP's by default)."""
    img = np.asarray(img, np.float32)
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def resize_image(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of an HWC uint8 or float image to float32 with a
    channel dim. ``size``: an int for a square, or ``(h, w)``."""
    th, tw = (size, size) if isinstance(size, int) else size
    h, w = img.shape[:2]
    if (h, w) == (th, tw):
        out = np.asarray(img, np.float32)
        return out[..., None] if out.ndim == 2 else out
    ys = np.linspace(0, h - 1, th)
    xs = np.linspace(0, w - 1, tw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    # f32 weights: f64 ones would widen the whole output
    wy = (ys - y0)[:, None, None].astype(np.float32)
    wx = (xs - x0)[None, :, None].astype(np.float32)
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """The central ``size`` x ``size`` crop of an HWC image."""
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return img[top : top + size, left : left + size]


def pad_or_trim(x: np.ndarray, length: int, axis: int = -1) -> np.ndarray:
    """Zero-pad or cut ``x`` to ``length`` along ``axis``."""
    x = np.asarray(x)
    cur = x.shape[axis]
    if cur == length:
        return x
    if cur > length:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, length)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, length - cur)
    return np.pad(x, pad)
