"""SUN RGB-D dataset — reads the reference's on-disk protocol.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.sunrgbd`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/sunrgbd.py. A user pointing this
loader at data prepared for the reference gets the same samples in the same
order:

- ``<root>/{split}.txt`` — newline-separated file ids whose FIRST path
  component is the sensor type, e.g. ``kv1/NYUdata/0001``
  (sunrgbd.py:156-170);
- ``<root>/<split>/rgb/<id>.jpg``, ``<root>/<split>/depth/<id>.png``,
  ``<root>/<split>/intrinsics/<id>.txt`` (first token of the first line is
  the focal length), ``<root>/<split>/scene_class/<id>.txt``
  (sunrgbd.py:160-178);
- per-sensor stereo baselines (``sensor_to_params``, sunrgbd.py:47-63);
- disparity = ``baseline * focal / clip(depth_png / 1000, 0.01, 50)``
  (sunrgbd.py:66-104);
- scene labels (underscores → spaces) index a FIXED 19-class list; unknown
  scenes get index 19 and the test split drops them (sunrgbd.py:23-43,
  180-197).

Differences from the reference (documented, deliberate): RGB decodes as
actual RGB (the reference feeds cv2 BGR arrays through ``to_pil_image``
unswapped), and ``image_size`` resizes rgb + depth to fixed square shapes
for static batch shapes; ``image_size=None`` returns the reference's
raw-resolution arrays. Differential test:
tests/datasets/test_reference_dataset_protocol.py.
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
from mmlearn_tpu_torch.datasets.builtin.nyuv2 import _read_ids, _read_scene_label
from mmlearn_tpu_torch.datasets.core.example import Example

#: reference sunrgbd.py:23-43 — scene classes, fixed order
SUNRGBD_LABELS = (
    "bathroom",
    "bedroom",
    "classroom",
    "computer room",
    "conference room",
    "corridor",
    "dining area",
    "dining room",
    "discussion area",
    "furniture store",
    "home office",
    "kitchen",
    "lab",
    "lecture theatre",
    "library",
    "living room",
    "office",
    "rest space",
    "study space",
)

#: reference sunrgbd.py:47-63 (from the omnivore issue tracker)
SENSOR_TO_PARAMS = {
    "kv1": {"baseline": 0.075},
    "kv1_b": {"baseline": 0.075},
    "kv2": {"baseline": 0.075},
    "realsense": {"baseline": 0.095},
    "xtion": {"baseline": 0.095},
}


def convert_depth_to_disparity(
    depth: np.ndarray,
    focal_length: float,
    sensor_type: str,
    min_depth: float = 0.01,
    max_depth: float = 50.0,
) -> np.ndarray:
    """Reference ``convert_depth_to_disparity`` (sunrgbd.py:66-104):
    millimeter depth PNG → disparity via the sensor baseline + focal
    length, with the depth clipped to [min_depth, max_depth] meters."""
    baseline = SENSOR_TO_PARAMS[sensor_type]["baseline"]
    depth_m = np.clip(depth.astype(np.float32) / 1000.0, min_depth, max_depth)
    return (baseline * focal_length / depth_m).astype(np.float32)


def _read_focal_length(path: str) -> float:
    with open(path) as f:
        return float(f.readline().strip().split()[0])


@store(group="datasets", name="SUNRGBD", populate_full_signature=False)
class SUNRGBD:
    """SUN RGB-D loader (reference disk protocol)."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        return_type: str = "disparity",  # disparity | image
        rgb_transform: Optional[Callable] = None,
        depth_transform: Optional[Callable] = None,
        image_size: Optional[int] = 224,
    ) -> None:
        root_dir = root_dir or os.environ.get("SUNRGBD_ROOT_DIR")
        if root_dir is None:
            raise ValueError("SUNRGBD requires root_dir (or $SUNRGBD_ROOT_DIR)")
        if split not in ("train", "test"):
            raise ValueError(f"Invalid split '{split}' (train|test)")
        if return_type not in ("disparity", "image"):
            raise ValueError(f"Invalid return_type '{return_type}'")
        file_ids = _read_ids(root_dir, split)
        base = os.path.join(root_dir, split)
        rgb_files = [os.path.join(base, "rgb", f"{f}.jpg") for f in file_ids]
        depth_files = [os.path.join(base, "depth", f"{f}.png") for f in file_ids]
        intrinsic_files = [
            os.path.join(base, "intrinsics", f"{f}.txt") for f in file_ids
        ]
        # sensor type = first path component of the file id
        # (reference sunrgbd.py:167-170)
        sensor_types = [f.split("/")[0] for f in file_ids]
        labels = [
            _read_scene_label(
                os.path.join(base, "scene_class", f"{f}.txt"), SUNRGBD_LABELS
            )
            for f in file_ids
        ]
        if split == "test":
            # ImageBind protocol (reference sunrgbd.py:185-197)
            keep = [i for i, l in enumerate(labels) if l < len(SUNRGBD_LABELS)]
            rgb_files = [rgb_files[i] for i in keep]
            depth_files = [depth_files[i] for i in keep]
            labels = [labels[i] for i in keep]
            intrinsic_files = [intrinsic_files[i] for i in keep]
            sensor_types = [sensor_types[i] for i in keep]
        self.samples = list(
            zip(rgb_files, depth_files, labels, intrinsic_files, sensor_types)
        )
        self.return_type = return_type
        self.image_size = image_size
        if rgb_transform is None and image_size is not None:
            rgb_transform = ImageTransform(size=image_size)
        self.rgb_transform = rgb_transform
        self.depth_transform = depth_transform

    def __len__(self) -> int:
        return len(self.samples)

    def _load_depth(
        self, path: str, intrinsics_path: str, sensor_type: str
    ) -> np.ndarray:
        from PIL import Image

        raw = np.asarray(Image.open(path))
        if self.return_type == "disparity":
            depth = convert_depth_to_disparity(
                raw, _read_focal_length(intrinsics_path), sensor_type
            )
        else:
            # reference sunrgbd.py:257-263 reads via cv2.IMREAD_GRAYSCALE:
            # 16-bit PNGs are stripped to their HIGH byte (libpng
            # png_set_strip_16) before the 3-channel repeat
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

        # aspect-preserving short-side resize + center crop (keeps the
        # depth map spatially aligned with its RGB pair; see nyuv2.py)
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
        rgb_path, depth_path, label, intr_path, sensor = self.samples[idx]
        rgb = load_image(rgb_path)
        if self.rgb_transform is not None:
            rgb = to_model_dtype(self.rgb_transform(rgb))
        else:
            rgb = np.asarray(rgb)
        return Example(
            {
                "rgb": rgb,
                "depth": self._load_depth(depth_path, intr_path, sensor).astype(
                    np.float32
                ),
                "depth_target": label,
                EXAMPLE_INDEX_KEY: idx,
            }
        )
