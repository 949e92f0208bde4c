"""CheXpert chest X-ray dataset.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.chexpert`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/chexpert.py — JSON-manifest loader
with labeler variants. Manifest naming follows the reference exactly
(chexpert.py:76-80): the ``valid`` split reads ``valid_data.json`` (labeled
by radiologists, no labeler), ``train`` reads
``{labeler}_train_data.json``. Each record is
``{"image_path": ..., "label": [14 floats], "qid": ...}``; relative image
paths resolve against ``root_dir`` (the reference requires absolute or
cwd-relative paths — ours is a superset).
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


@store(group="datasets", name="CheXpert", populate_full_signature=False)
class CheXpert:
    """CheXpert with 14-label targets."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        labeler: str = "chexpert",
        transform: Optional[Callable] = None,
        image_size: int = 224,
    ) -> None:
        root_dir = root_dir or os.environ.get("CHEXPERT_ROOT_DIR")
        if root_dir is None:
            raise ValueError("CheXpert requires root_dir (or $CHEXPERT_ROOT_DIR)")
        if split not in ("train", "valid"):
            raise ValueError(f"Invalid split '{split}'")
        if labeler not in ("chexpert", "chexbert", "vchexbert", None):
            raise ValueError(f"Invalid labeler '{labeler}'")
        self.root_dir = root_dir
        # reference manifest names (chexpert.py:76-80): the valid split was
        # labeled by radiologists and has no labeler variant
        if split == "valid":
            manifest = os.path.join(root_dir, "valid_data.json")
        else:
            if labeler is None:
                raise ValueError(
                    "CheXpert train split requires a labeler "
                    "(chexpert|chexbert|vchexbert) — only the "
                    "radiologist-labeled valid split has none"
                )
            manifest = os.path.join(root_dir, f"{labeler}_{split}_data.json")
        with open(manifest) as f:
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
        example = Example(
            {
                "rgb": to_model_dtype(img),
                "rgb_target": np.asarray(entry["label"], np.float32),
                EXAMPLE_INDEX_KEY: idx,
            }
        )
        if "qid" in entry:  # reference passthrough (chexpert.py:104)
            example["qid"] = entry["qid"]
        return example
