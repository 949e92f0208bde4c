"""The BIOSCAN insect dataset (image, DNA barcode and taxonomy text), the
port's copy of ``projects.bioscan_clip.dataset``: one of the 13 named splits
of the BIOSCAN-1M or -5M HDF5 file; each example's JPEG bytes cut to its
``image_mask`` length and decoded by the fastloader with CLIP's statistics
(:func:`~mmlearn_tpu_torch.datasets.builtin.image_utils.decode_transform_jpeg`,
the train transform when ``for_training``), the barcode tokenized by the
k-mer :class:`DNAProcessor`, the stored language tokens, and for evaluation
the taxonomy label dicts. Importing it registers the ``dna`` modality.
Needs ``h5py``, imported when a dataset is made.
"""

from __future__ import annotations

from typing import Literal, Optional, Union

import numpy as np

from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    CLIP_MEAN,
    CLIP_STD,
    ImageTransform,
    decode_transform_jpeg,
)
from mmlearn_tpu_torch.datasets.core import Example, Modalities
from mmlearn_tpu_torch.projects.bioscan_clip.dna_tokenizer import DNAProcessor

if not Modalities.has_modality("dna"):
    Modalities.register_modality("dna")

SPLITS = (
    "all_keys",
    "no_split",
    "no_split_and_seen_train",
    "seen_keys",
    "single_species",
    "test_seen",
    "test_unseen",
    "test_unseen_keys",
    "train_seen",
    "val_seen",
    "val_unseen",
    "val_unseen_keys",
    "unseen_keys",
)

LEVELS = ("order", "family", "genus", "species")


def _text(value) -> str:
    return value.decode("utf-8") if isinstance(value, bytes) else str(value)


class BIOSCANInsectDataset:
    """An HDF5-backed split of image, DNA and text triples. ``labels`` are
    the examples' indices for training (or the ints given), the taxonomy
    dicts (``order`` to ``species``, ``"unknown"`` where a level is absent)
    for evaluation."""

    def __init__(
        self,
        path_to_hdf5_file: str,
        variant: Literal["1m", "5m"] = "1m",
        split: str = "train_seen",
        image_input_type: Literal["image", "feature"] = "image",
        dna_input_type: Literal["sequence", "feature"] = "sequence",
        dna_processor: Optional[DNAProcessor] = None,
        labels: Optional[Union[int, list]] = None,
        for_training: bool = True,
        image_size: int = 224,
    ) -> None:
        try:
            import h5py
        except ImportError as err:
            raise ImportError("BIOSCANInsectDataset reads its HDF5 file through h5py, which is "
                              f"not installed ({err})") from err

        if split not in SPLITS:
            raise ValueError(f"Unknown split '{split}'; expected one of {SPLITS}")
        self.variant = variant
        self.split = split
        self.image_input_type = image_input_type
        self.dna_input_type = dna_input_type
        self.for_training = for_training
        self.dna_processor = dna_processor or DNAProcessor(max_length=660)
        self.data = h5py.File(path_to_hdf5_file, "r", libver="latest")[split]
        self.transform = ImageTransform(size=image_size, mean=CLIP_MEAN, std=CLIP_STD,
                                        train=for_training)
        if for_training:
            # training reads no taxonomy string: 4 string columns of the
            # split are not decoded
            self.labels = np.arange(len(self)) if labels is None else np.asarray(labels)
        else:
            self.label_dicts = self._load_label_dicts()
            self.labels = self.label_dicts

    def _load_label_dicts(self) -> list[dict[str, str]]:
        n = len(self.data["image"])
        decoded = {level: ([_text(v) for v in self.data[level][:]] if level in self.data
                           else ["unknown"] * n) for level in LEVELS}
        return [{level: decoded[level][i] for level in LEVELS} for i in range(n)]

    def __len__(self) -> int:
        return len(self.data["image"])

    def _image_bytes(self, idx: int) -> bytes:
        enc = self.data["image"][idx].astype(np.uint8)
        return enc[: int(self.data["image_mask"][idx])].tobytes()

    def __getitem__(self, idx: int) -> Example:
        if self.image_input_type == "image":
            image = decode_transform_jpeg(self._image_bytes(idx), self.transform).astype(
                np.float32)
        else:
            image = self.data["image_features"][idx].astype(np.float32)
        if self.dna_input_type == "sequence":
            dna = self.dna_processor(_text(self.data["barcode"][idx]))
        else:
            dna = self.data["dna_features"][idx].astype(np.float32)
        pid_key = "processid" if self.variant == "5m" else "image_file"
        text = Modalities.get_modality("text")
        example = Example({
            EXAMPLE_INDEX_KEY: idx,
            Modalities.get_modality("rgb").name: image,
            Modalities.get_modality("dna").name: dna,
            text.name: np.asarray(self.data["language_tokens_input_ids"][idx], np.int32),
            "language_token_type_ids": np.asarray(
                self.data["language_tokens_token_type_ids"][idx], np.int32),
            text.attention_mask: np.asarray(self.data["language_tokens_attention_mask"][idx],
                                            np.int32),
            "process_id": _text(self.data[pid_key][idx]),
            "split": self.split,
        })
        example["labels"] = int(self.labels[idx]) if self.for_training else self.labels[idx]
        return example
