"""``Example`` and cross-modal id matching, counterpart of
:mod:`mmlearn_tpu.datasets.core.example` (``Example`` :21,
``find_matching_indices`` :64).

An ``Example`` is an ordered dict with attribute access; ``create_ids()``
stamps ``example_ids[key] = [dataset_index, example_index]`` for every
other key. Arrays are numpy: tensors appear only after collation, when the
trainer's feeder places the batch.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import numpy as np

from mmlearn_tpu_torch.constants import DATASET_INDEX_KEY, EXAMPLE_INDEX_KEY


class Example(OrderedDict):
    """An ordered dict with attribute-style access for a single example."""

    def __init__(self, init_dict: dict | None = None) -> None:
        super().__init__()
        if init_dict:
            for key, value in init_dict.items():
                self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"Example has no attribute '{key}'") from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def create_ids(self) -> None:
        """Stamp per-key ``(dataset_index, example_index)`` id pairs on every
        key but the reserved ones. Needs ``example_index`` and
        ``dataset_index`` (set by the dataset and by
        :class:`~mmlearn_tpu_torch.datasets.core.combined_dataset.CombinedDataset`)."""
        if EXAMPLE_INDEX_KEY not in self or DATASET_INDEX_KEY not in self:
            raise ValueError(
                "Cannot create ids: 'example_index' and 'dataset_index' "
                "must both be set on the example first."
            )
        idx = np.asarray(
            [int(self[DATASET_INDEX_KEY]), int(self[EXAMPLE_INDEX_KEY])], dtype=np.int64
        )
        self["example_ids"] = {
            key: idx
            for key in self.keys()
            if key not in ("example_ids", EXAMPLE_INDEX_KEY, DATASET_INDEX_KEY)
        }


def find_matching_indices(
    first_example_ids: np.ndarray, second_example_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Row indices where two ``(N, 2)`` / ``(M, 2)`` id arrays match:
    ``(indices_into_first, indices_into_second)`` with
    ``first[i] == second[j]`` pairwise. The collator's missing-id sentinel
    ``(-1, -1)`` matches nothing."""
    first = np.asarray(first_example_ids)
    second = np.asarray(second_example_ids)
    if first.ndim != 2 or first.shape[-1] != 2:
        raise ValueError(f"Expected first_example_ids of shape (N, 2), got {first.shape}")
    if second.ndim != 2 or second.shape[-1] != 2:
        raise ValueError(f"Expected second_example_ids of shape (M, 2), got {second.shape}")
    matches = (first[:, None, :] == second[None, :, :]).all(axis=-1)
    # two examples that both lack a modality must not match each other
    valid = (first >= 0).all(axis=-1)[:, None] & (second >= 0).all(axis=-1)[None, :]
    matches &= valid
    first_idx, second_idx = np.nonzero(matches)
    return first_idx.astype(np.int64), second_idx.astype(np.int64)
