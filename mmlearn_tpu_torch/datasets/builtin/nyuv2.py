"""NYUv2 RGB-D dataset — reads the reference's on-disk protocol.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.nyuv2`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/nyuv2.py. A user pointing this
loader at data prepared for the reference gets the same samples in the same
order:

- ``<root>/{split}.txt`` — newline-separated file ids (nyuv2.py:117-119);
- ``<root>/<split>/rgb/<id>.png`` and ``<root>/<split>/depth/<id>.png``
  (nyuv2.py:121-123);
- ``<root>/<split>/scene_class/<id>.txt`` — scene label text per file
  (nyuv2.py:125-128).

Depth ``"disparity"`` mode is the reference's ``depth_normalize``:
``clip(depth_png / 1000, 0.01, 50)`` meters (nyuv2.py:38-64; despite the
name, no reciprocal is taken). Scene labels (underscores → spaces) index a
FIXED 10-class ImageBind list; unknown scenes get index 10 and the test
split drops them (nyuv2.py:130-146).

Differences from the reference (documented, deliberate):

- RGB decodes as actual RGB. The reference feeds ``cv2.imread`` BGR arrays
  through ``to_pil_image`` untouched, so its channels are swapped; the
  differential test (tests/datasets/test_reference_dataset_protocol.py)
  pins ours == reference[..., ::-1].
- ``image_size`` resizes rgb + depth to fixed square shapes for static batch
  shapes (aspect-preserving short-side resize + center crop on both so
  the pair stays spatially aligned); ``image_size=None`` returns the
  reference's raw-resolution arrays.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    ImageTransform,
    load_image,
    to_model_dtype,
)
from mmlearn_tpu_torch.datasets.core.example import Example

#: reference nyuv2.py:24-35 — ImageBind's NYUv2 scene classes, fixed order
NYUV2_LABELS = (
    "bedroom",
    "kitchen",
    "living room",
    "bathroom",
    "dining room",
    "office",
    "furniture store",
    "classroom",
    "home office",
    "bookstore",
)


def depth_normalize(
    depth: np.ndarray, min_depth: float = 0.01, max_depth: float = 50.0
) -> np.ndarray:
    """Reference ``depth_normalize`` (nyuv2.py:38-64): millimeter PNG →
    meters, clipped to [min_depth, max_depth]."""
    depth_m = depth.astype(np.float32) / 1000.0
    return np.clip(depth_m, min_depth, max_depth)


def _read_ids(root_dir: str, split: str) -> list[str]:
    path = os.path.join(root_dir, f"{split}.txt")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _read_scene_label(path: str, labels: tuple) -> int:
    with open(path) as f:
        text = f.read().strip().replace("_", " ")
    return labels.index(text) if text in labels else len(labels)


@store(group="datasets", name="NYUv2", populate_full_signature=False)
class NYUv2:
    """NYUv2 RGB+depth loader (reference disk protocol)."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        return_type: str = "disparity",  # disparity | image
        rgb_transform: Optional[Callable] = None,
        depth_transform: Optional[Callable] = None,
        image_size: Optional[int] = 224,
    ) -> None:
        root_dir = root_dir or os.environ.get("NYUV2_ROOT_DIR")
        if root_dir is None:
            raise ValueError("NYUv2 requires root_dir (or $NYUV2_ROOT_DIR)")
        if split not in ("train", "test"):
            raise ValueError(f"Invalid split '{split}' (train|test)")
        if return_type not in ("disparity", "image"):
            raise ValueError(f"Invalid return_type '{return_type}'")
        file_ids = _read_ids(root_dir, split)
        base = os.path.join(root_dir, split)
        rgb_files = [os.path.join(base, "rgb", f"{f}.png") for f in file_ids]
        depth_files = [os.path.join(base, "depth", f"{f}.png") for f in file_ids]
        labels = [
            _read_scene_label(
                os.path.join(base, "scene_class", f"{f}.txt"), NYUV2_LABELS
            )
            for f in file_ids
        ]
        # ImageBind protocol: the test split keeps only known scene classes
        # (reference nyuv2.py:135-146)
        if split == "test":
            keep = [i for i, l in enumerate(labels) if l < len(NYUV2_LABELS)]
            rgb_files = [rgb_files[i] for i in keep]
            depth_files = [depth_files[i] for i in keep]
            labels = [labels[i] for i in keep]
        self.samples = list(zip(rgb_files, depth_files, labels))
        self.return_type = return_type
        self.image_size = image_size
        if rgb_transform is None and image_size is not None:
            rgb_transform = ImageTransform(size=image_size)
        self.rgb_transform = rgb_transform
        self.depth_transform = depth_transform

    def __len__(self) -> int:
        return len(self.samples)

    def _load_depth(self, path: str) -> np.ndarray:
        from PIL import Image

        raw = np.asarray(Image.open(path))
        if self.return_type == "disparity":
            depth = depth_normalize(raw)
        else:
            # 3-channel depth image for pretrained ViTs (reference
            # nyuv2.py:192-199 reads via cv2.IMREAD_GRAYSCALE, which strips
            # 16-bit PNGs to their HIGH byte — libpng png_set_strip_16)
            if raw.dtype == np.uint16:
                raw = (raw >> 8).astype(np.uint8)
            depth = np.repeat(
                raw.astype(np.float32)[:, :, np.newaxis], 3, axis=-1
            )
        if self.depth_transform is not None:
            return np.asarray(self.depth_transform(depth))
        if self.image_size is None:
            return depth
        from mmlearn_tpu_torch.datasets.processors.transforms import (
            center_crop,
            resize_image,
        )

        # aspect-preserving short-side resize + center crop, mirroring the
        # RGB ImageTransform eval path — a square resize would stretch the
        # short axis and spatially misalign depth with its RGB pair
        h, w = depth.shape[:2]
        scale = self.image_size / min(h, w)
        resized = resize_image(
            depth, (int(round(h * scale)), int(round(w * scale)))
        )
        cropped = center_crop(resized, self.image_size)
        if cropped.ndim == 2:
            cropped = cropped.reshape(self.image_size, self.image_size, 1)
        return cropped

    def __getitem__(self, idx: int) -> Example:
        rgb_path, depth_path, label = self.samples[idx]
        rgb = load_image(rgb_path)
        if self.rgb_transform is not None:
            rgb = to_model_dtype(self.rgb_transform(rgb))
        else:
            rgb = np.asarray(rgb)
        return Example(
            {
                "rgb": rgb,
                "depth": self._load_depth(depth_path).astype(np.float32),
                "depth_target": label,
                EXAMPLE_INDEX_KEY: idx,
            }
        )
