"""NIH Chest X-ray dataset.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.nihcxr`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/nihcxr.py — JSON-manifest chest
X-ray loader (reference line 44). Manifest: JSON list of
``{"image_path": ..., "label": [...]}``.
"""

from __future__ import annotations

import json
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


@store(group="datasets", name="NIHCXR", populate_full_signature=False)
class NIHCXR:
    """NIH chest X-ray loader with multi-label targets."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        transform: Optional[Callable] = None,
        image_size: int = 224,
    ) -> None:
        root_dir = root_dir or os.environ.get("NIHCXR_ROOT_DIR")
        if root_dir is None:
            raise ValueError("NIHCXR requires root_dir (or $NIHCXR_ROOT_DIR)")
        if split not in ("train", "test", "bbox"):
            raise ValueError(f"Invalid split '{split}'")
        self.root_dir = root_dir
        with open(os.path.join(root_dir, f"{split}_data.json")) as f:
            self.entries = json.load(f)
        self.transform = transform or ImageTransform(size=image_size)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Example:
        entry = self.entries[idx]
        path = entry.get("image_path") or entry.get("Path")
        if not os.path.isabs(path):
            path = os.path.join(self.root_dir, path)
        img = self.transform(load_image(path))
        return Example(
            {
                "rgb": to_model_dtype(img),
                "rgb_target": np.asarray(entry["label"], np.float32),
                EXAMPLE_INDEX_KEY: idx,
            }
        )
