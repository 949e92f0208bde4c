"""Synthetic datasets for smoke runs and benchmarks, counterpart of
:mod:`mmlearn_tpu.datasets.builtin.synthetic` (``SyntheticImageText`` :18,
``SyntheticImages`` :71): the same arrays item for item from the same seed.
"""

from __future__ import annotations

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core.example import Example


@store(group="datasets", name="SyntheticImageText", populate_full_signature=False)
class SyntheticImageText:
    """Correlated (image, token sequence) pairs: class k shows image pattern
    k (float32, standard normal, plus 0.05 of noise drawn from the index)
    and token pattern k, ending in the end-of-text id ``vocab_size - 1``."""

    def __init__(
        self,
        size: int = 1024,
        image_size: int = 224,
        seq_len: int = 77,
        vocab_size: int = 49408,
        num_classes: int = 64,
        seed: int = 0,
        with_target: bool = False,
    ) -> None:
        self.size = size
        self.image_size = image_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_classes = num_classes
        self.with_target = with_target
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, size)
        self.patterns = rng.standard_normal(
            (num_classes, image_size, image_size, 3)).astype(np.float32)
        self.token_patterns = rng.integers(
            2, vocab_size - 1, size=(num_classes, seq_len)).astype(np.int32)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Example:
        k = int(self.labels[idx])
        rng = np.random.default_rng(idx)
        img = self.patterns[k] + 0.05 * rng.standard_normal(
            (self.image_size, self.image_size, 3)).astype(np.float32)
        ids = self.token_patterns[k].copy()
        ids[-1] = self.vocab_size - 1  # end of text: the largest id, for EOS pooling
        ex = Example({
            "rgb": img,
            "text": ids,
            "text_attention_mask": np.ones(self.seq_len, np.int32),
            EXAMPLE_INDEX_KEY: idx,
        })
        if self.with_target:
            ex["rgb_target"] = k
        return ex


@store(group="datasets", name="SyntheticImages", populate_full_signature=False)
class SyntheticImages:
    """Unlabeled standard-normal float32 images (I-JEPA), drawn from
    ``seed + index``."""

    def __init__(self, size: int = 1024, image_size: int = 224, seed: int = 0) -> None:
        self.size = size
        self.image_size = image_size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Example:
        rng = np.random.default_rng(self.seed + idx)
        return Example({
            "rgb": rng.standard_normal(
                (self.image_size, self.image_size, 3)).astype(np.float32),
            EXAMPLE_INDEX_KEY: idx,
        })
