"""LLVIP paired visible/infrared dataset.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.llvip`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/llvip.py — paired RGB + thermal
images with optional XML bounding-box annotations (reference lines 68-97).
Layout: ``<root>/visible/<split>/*.jpg`` and ``<root>/infrared/<split>/*.jpg``
with ``<root>/Annotations/*.xml``.
"""

from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET
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

MAX_BBOXES = 32  # fixed slots (static shapes); extra boxes are dropped


@store(group="datasets", name="LLVIP", populate_full_signature=False)
class LLVIP:
    """Paired visible/IR loader with optional bbox parsing."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        train: bool = True,
        transform: Optional[Callable] = None,
        include_bboxes: bool = False,
        image_size: int = 224,
    ) -> None:
        root_dir = root_dir or os.environ.get("LLVIP_ROOT_DIR")
        if root_dir is None:
            raise ValueError("LLVIP requires root_dir (or $LLVIP_ROOT_DIR)")
        self.root_dir = root_dir
        split = "train" if train else "test"
        self.vis_paths = sorted(
            glob.glob(os.path.join(root_dir, "visible", split, "*.jpg"))
        )
        if not self.vis_paths:
            raise FileNotFoundError(
                f"No images under {root_dir}/visible/{split}"
            )
        self.include_bboxes = include_bboxes and train
        self.transform = transform or ImageTransform(size=image_size)

    def __len__(self) -> int:
        return len(self.vis_paths)

    def _bboxes(self, name: str) -> np.ndarray:
        """Parse XML annotations into fixed (MAX_BBOXES, 4) slots."""
        out = np.full((MAX_BBOXES, 4), -1, np.float32)
        xml_path = os.path.join(self.root_dir, "Annotations", f"{name}.xml")
        if not os.path.isfile(xml_path):
            return out
        tree = ET.parse(xml_path)
        for i, obj in enumerate(tree.getroot().iter("object")):
            if i >= MAX_BBOXES:
                break
            box = obj.find("bndbox")
            out[i] = [
                float(box.find(k).text)
                for k in ("xmin", "ymin", "xmax", "ymax")
            ]
        return out

    def __getitem__(self, idx: int) -> Example:
        vis_path = self.vis_paths[idx]
        ir_path = vis_path.replace(
            os.sep + "visible" + os.sep, os.sep + "infrared" + os.sep
        )
        rgb = self.transform(load_image(vis_path))
        thermal = self.transform(load_image(ir_path))
        example = Example(
            {
                "rgb": to_model_dtype(rgb),
                "thermal": to_model_dtype(thermal),
                EXAMPLE_INDEX_KEY: idx,
            }
        )
        if self.include_bboxes:
            name = os.path.splitext(os.path.basename(vis_path))[0]
            example["bboxes"] = self._bboxes(name)
        return example
