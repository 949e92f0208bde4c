"""Shared loaders of the med_benchmarking datasets, counterpart of
``projects.med_benchmarking.datasets.base``: ``HFImageClassification`` :62
(HuggingFace-hub image classification), ``CSVImageClassification`` :128
(CSV metadata and an image directory) and ``ImageTextManifest`` :168
((image, caption) pairs from a jsonl or CSV manifest).

The CSV files are read with the stdlib :mod:`csv` module, not pandas:
:func:`read_csv` types each column as ``pandas.read_csv`` does on these
files (a column of integer literals reads as ints, one of decimal literals
as floats, any other as strings; blank lines are skipped), so labels, paths,
the ``split`` and ``subset`` filters and captions come out as the JAX
package's. One departure: an empty cell of a string column reads as ``""``
where pandas reads NaN, so an empty caption is the caption ``""``, not
``"nan"`` (and pandas' other NA spellings, ``NA``, ``null``, ``None`` and
the like, stay the strings they are).

Images load with PIL and go through the transform (the eval
:class:`ImageTransform` with CLIP's statistics unless one is given); the
transform's output dtype is kept (``to_model_dtype``: float32, or uint8 for
a ``device_normalize`` transform).
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Any, Callable, Optional

import numpy as np

from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    ImageTransform,
    load_image,
    to_model_dtype,
)
from mmlearn_tpu_torch.datasets.core.example import Example

#: zero-shot prompt templates of the histopathology sets (pcam, bach, sicap)
HISTOPATHOLOGY_TEMPLATES = [
    "a histopathology slide showing {}.",
    "histopathology image of {}.",
    "pathology tissue showing {}.",
    "presence of {} tissue on image.",
]

#: zero-shot prompt templates of the dermatology sets
DERMATOLOGY_TEMPLATES = [
    "a photo of a {}.",
    "a dermoscopic image of {}.",
    "an image of {} skin lesion.",
]

_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _typed_column(cells: list[str]) -> list[Any]:
    """One column's cells typed as ``pandas.read_csv`` types them: all
    integer literals -> ``int``; all decimal literals (empties as NaN) ->
    ``float``; otherwise strings, an empty cell ``""``."""
    filled = [c for c in cells if c != ""]
    if filled and len(filled) == len(cells) and all(_INT.fullmatch(c) for c in filled):
        return [int(c) for c in cells]
    if filled and all(_FLOAT.fullmatch(c) for c in filled):
        return [float(c) if c != "" else float("nan") for c in cells]
    return list(cells)


def read_csv(path: str, sep: str = ",") -> list[dict[str, Any]]:
    """The rows of a CSV file with a header line, as dicts keyed by column,
    each column typed by :func:`_typed_column`."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader)
        rows = [row for row in reader if row]
    for row in rows:
        if len(row) != len(header):
            raise ValueError(f"{path}: a row of {len(row)} fields under a header of "
                             f"{len(header)}: {row}")
    columns = [_typed_column([row[i] for row in rows]) for i in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)]


class _MedDatasetBase:
    id2label: dict[int, str] = {}
    zero_shot_prompt_templates: list[str] = HISTOPATHOLOGY_TEMPLATES

    def __init__(self, transform: Optional[Callable] = None, image_size: int = 224):
        self.transform = transform or ImageTransform(size=image_size)

    def _example(self, image: Any, label: Any, idx: int) -> Example:
        return Example({
            "rgb": to_model_dtype(self.transform(np.asarray(image))),
            "rgb_target": int(label),
            EXAMPLE_INDEX_KEY: idx,
        })


class HFImageClassification(_MedDatasetBase):
    """HuggingFace-hub image classification, two split protocols:
    ``hub_splits`` names the splits passed to the hub as they are (PCAM's
    and NCK-CRC's official splits); any other ``train`` or ``test`` is the
    seeded 75/25 ``train_test_split`` of the hub's ``train`` split (BACH's
    protocol). ``exclude_labels`` drops rows by label (NCK-CRC's ``BACK``);
    ``label_mapping`` maps a string label to its class id. Needs the
    ``datasets`` package."""

    hub_name: str = ""
    image_key: str = "image"
    label_key: str = "label"
    split_seed: int = 0
    test_size: float = 0.25
    hub_splits: tuple = ()
    exclude_labels: tuple = ()
    label_mapping: Optional[dict[str, int]] = None

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        transform: Optional[Callable] = None,
        image_size: int = 224,
        hub_name: Optional[str] = None,
    ) -> None:
        super().__init__(transform, image_size)
        try:
            from datasets import load_dataset
        except ImportError as err:
            raise ImportError(f"{type(self).__name__} reads the HuggingFace hub through the "
                              f"'datasets' package, which is not installed ({err})") from err

        name = hub_name or self.hub_name
        cache_dir = os.path.join(root_dir, "scratch/")
        if split in self.hub_splits:
            dataset = load_dataset(name, cache_dir=cache_dir, split=split)
        else:
            dataset = load_dataset(name, cache_dir=cache_dir, split="train")
            if split in ("train", "test"):
                parts = dataset.train_test_split(test_size=self.test_size,
                                                 train_size=1 - self.test_size, shuffle=True,
                                                 seed=self.split_seed)
                dataset = parts[split]
        if self.exclude_labels:
            excluded, key = set(self.exclude_labels), self.label_key
            dataset = dataset.filter(lambda row: row[key] not in excluded)
        self.data = dataset

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Example:
        entry = self.data[idx]
        label = entry[self.label_key]
        if self.label_mapping is not None:
            label = self.label_mapping[str(label)]
        return self._example(entry[self.image_key], label, idx)


class CSVImageClassification(_MedDatasetBase):
    """A CSV of image paths and labels, the images under ``image_subdir``;
    rows of a ``split`` column other than ``split`` are dropped. Labels map
    through ``label_names`` (by ``str``) where it is set, else are ints."""

    csv_name: str = "metadata.csv"
    path_column: str = "image"
    label_column: str = "label"
    image_subdir: str = "images"
    label_names: Optional[dict[str, int]] = None

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        transform: Optional[Callable] = None,
        image_size: int = 224,
    ) -> None:
        super().__init__(transform, image_size)
        self.root_dir = root_dir
        rows = read_csv(os.path.join(root_dir, self.csv_name))
        if rows and "split" in rows[0]:
            rows = [row for row in rows if row["split"] == split]
        self.paths = [row[self.path_column] for row in rows]
        raw = [row[self.label_column] for row in rows]
        if self.label_names:
            self.labels = [self.label_names[str(v)] for v in raw]
        else:
            self.labels = [int(v) for v in raw]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Example:
        path = self.paths[idx]
        if not os.path.isabs(path):
            path = os.path.join(self.root_dir, self.image_subdir, path)
        return self._example(load_image(path), self.labels[idx], idx)


class ImageTextManifest:
    """(image, caption) pairs from ``<root>/<split>.<file_type>``: jsonl (one
    object a line) or CSV (``csv_separator``); relative image paths resolve
    under ``image_dir``. The caption is tokenized by ``tokenizer`` where one
    is given, else kept as the string ``text`` (the collator's batch
    processor tokenizes it)."""

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        file_type: str = "jsonl",
        image_key: str = "image",
        caption_key: str = "caption",
        csv_separator: str = ",",
        image_dir: str = "images",
        transform: Optional[Callable] = None,
        tokenizer: Optional[Callable] = None,
        image_size: int = 224,
    ) -> None:
        self.root_dir = root_dir
        self.image_dir = image_dir
        self.image_key = image_key
        self.caption_key = caption_key
        self.transform = transform or ImageTransform(size=image_size)
        self.tokenizer = tokenizer
        manifest = os.path.join(root_dir, f"{split}.{file_type}")
        if file_type == "jsonl":
            with open(manifest, encoding="utf-8") as f:
                self.entries: list[dict] = [json.loads(line) for line in f if line.strip()]
        else:
            self.entries = read_csv(manifest, sep=csv_separator)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Example:
        entry = self.entries[idx]
        path = entry[self.image_key]
        if not os.path.isabs(path):
            path = os.path.join(self.root_dir, self.image_dir, path)
        example = Example({"rgb": to_model_dtype(self.transform(load_image(path))),
                           EXAMPLE_INDEX_KEY: idx})
        caption = str(entry[self.caption_key])
        if self.tokenizer is not None:
            example.update(self.tokenizer(caption))
        else:
            example["text"] = caption
        return example
