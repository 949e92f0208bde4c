"""The med_benchmarking image-text datasets, counterpart of
``projects.med_benchmarking.datasets.image_text``: ``PMCOA`` :32, ``ROCO``
:40, ``Quilt`` :60 (a CSV with a ``subset`` filter), ``MIMICIVCXR`` :88 (the
``report`` as caption, the CheXpert ``label`` vector as ``rgb_target``) and
``MedVQA`` :118 (the question as text, the answer's id in a vocabulary
taken from the train split as ``rgb_target``). Each root comes from
``root_dir`` or from its environment variable (``PMCOA_ROOT_DIR`` and the
rest).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    ImageTransform,
    load_image,
    to_model_dtype,
)
from mmlearn_tpu_torch.datasets.core.example import Example
from mmlearn_tpu_torch.projects.med_benchmarking.datasets.base import ImageTextManifest


def _env_root(var: str, root_dir: Optional[str]) -> str:
    root = root_dir or os.environ.get(var)
    if root is None:
        raise ValueError(f"Set {var} or pass root_dir")
    return root


@external_store(group="datasets", name="PMCOA", populate_full_signature=False)
class PMCOA(ImageTextManifest):
    """PMC Open Access figure-caption pairs: ``<split>.jsonl`` and
    ``images/``."""

    def __init__(self, root_dir: Optional[str] = None, **kwargs: Any) -> None:
        super().__init__(_env_root("PMCOA_ROOT_DIR", root_dir), **kwargs)


@external_store(group="datasets", name="ROCO", populate_full_signature=False)
class ROCO(ImageTextManifest):
    """Radiology Objects in COntext: ``<split>.jsonl`` and ``images/``."""

    def __init__(self, root_dir: Optional[str] = None, split: str = "train",
                 **kwargs: Any) -> None:
        super().__init__(
            _env_root("ROCO_ROOT_DIR", root_dir),
            split=split,
            file_type=kwargs.pop("file_type", "jsonl"),
            image_key=kwargs.pop("image_key", "image"),
            caption_key=kwargs.pop("caption_key", "caption"),
            **kwargs,
        )


@external_store(group="datasets", name="Quilt", populate_full_signature=False)
class Quilt(ImageTextManifest):
    """Quilt-1M histopathology pairs: ``<split>.csv`` (``image_path``,
    ``caption``, ``subset``) and ``quilt_1m/``; ``subset`` keeps the rows of
    those subsets."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        subset: Optional[list] = None,
        **kwargs: Any,
    ) -> None:
        root = _env_root("QUILT_ROOT_DIR", root_dir)
        self.subset = subset
        super().__init__(
            root,
            split=split,
            file_type=kwargs.pop("file_type", "csv"),
            image_key=kwargs.pop("image_key", "image_path"),
            caption_key=kwargs.pop("caption_key", "caption"),
            image_dir=kwargs.pop("image_dir", "quilt_1m"),
            **kwargs,
        )
        if subset:
            self.entries = [e for e in self.entries if e.get("subset") in subset]


@external_store(group="datasets", name="MIMICIVCXR", populate_full_signature=False)
class MIMICIVCXR(ImageTextManifest):
    """MIMIC-IV-CXR image-report pairs: ``<split>.jsonl`` rows of an image
    path, the ``report`` and, where present, the CheXpert ``label`` vector
    (``rgb_target``, float32)."""

    def __init__(self, root_dir: Optional[str] = None, split: str = "train",
                 **kwargs: Any) -> None:
        super().__init__(
            _env_root("MIMICIVCXR_ROOT_DIR", root_dir),
            split=split,
            image_key=kwargs.pop("image_key", "image"),
            caption_key=kwargs.pop("caption_key", "report"),
            **kwargs,
        )

    def __getitem__(self, idx: int) -> Example:
        example = super().__getitem__(idx)
        entry = self.entries[idx]
        if "label" in entry:
            example["rgb_target"] = np.asarray(entry["label"], np.float32)
        return example


@external_store(group="datasets", name="MedVQA", populate_full_signature=False)
class MedVQA:
    """Medical visual question answering: ``<root>/<split>.json``, a list of
    ``{"image", "question", "answer", "answer_type"}``, images under
    ``images/``. An answer's id comes from ``<root>/answers.json`` where it
    exists, else from the sorted answers of the train split (for every
    split, so that the ids agree); an unknown answer is -1.
    ``include_ae_features`` adds ``<root>/ae_features/<image>.npy`` where
    the file exists."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        encoder_transform: Optional[Callable] = None,
        include_ae_features: bool = False,
        image_size: int = 224,
    ) -> None:
        root = _env_root("MEDVQA_ROOT_DIR", root_dir)
        self.root_dir = root
        with open(os.path.join(root, f"{split}.json"), encoding="utf-8") as f:
            self.entries = json.load(f)
        self.transform = encoder_transform or ImageTransform(size=image_size)
        self.include_ae_features = include_ae_features
        vocab_path = os.path.join(root, "answers.json")
        if os.path.isfile(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                answers = json.load(f)
        else:
            source = self.entries
            train_path = os.path.join(root, "train.json")
            if split != "train" and os.path.isfile(train_path):
                with open(train_path, encoding="utf-8") as f:
                    source = json.load(f)
            answers = sorted({str(e.get("answer", "")) for e in source})
        self.answer_to_id = {a: i for i, a in enumerate(answers)}
        self.id2label = {i: a for a, i in self.answer_to_id.items()}

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Example:
        entry = self.entries[idx]
        path = entry["image"]
        if not os.path.isabs(path):
            path = os.path.join(self.root_dir, "images", path)
        example = Example({
            "rgb": to_model_dtype(self.transform(load_image(path))),
            "text": str(entry["question"]),
            "rgb_target": self.answer_to_id.get(str(entry.get("answer")), -1),
            EXAMPLE_INDEX_KEY: idx,
        })
        if self.include_ae_features:
            feat = os.path.join(self.root_dir, "ae_features",
                                os.path.splitext(os.path.basename(path))[0] + ".npy")
            if os.path.isfile(feat):
                example["rgb_ae_features"] = np.load(feat).astype(np.float32)
        return example
