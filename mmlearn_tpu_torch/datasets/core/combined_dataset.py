"""Concatenation of datasets with provenance stamping, counterpart of
:mod:`mmlearn_tpu.datasets.core.combined_dataset` (``CombinedDataset`` :30).

Map-style datasets (``__getitem__`` and ``__len__``) are indexed through
their cumulative sizes; iterable ones are consumed in order, restarted at
``StopIteration``, under a lock (the loader fetches from a thread pool).
Every example gets ``dataset_index`` (and, from a stream, an
``example_index`` in this process's consumption order) and then its ids
(``Example.create_ids``).
"""

from __future__ import annotations

import bisect
import threading
from collections.abc import Iterable, Iterator, Sequence
from typing import Any

import numpy as np

from mmlearn_tpu_torch.constants import DATASET_INDEX_KEY, EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core.example import Example


def _is_map_style(dataset: Any) -> bool:
    return hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__")


class CombinedDataset:
    """Combine map- or iterable-style datasets into one."""

    def __init__(self, datasets: Sequence[Any] | Iterable[Any]) -> None:
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("CombinedDataset requires at least one dataset")
        for ds in self.datasets:
            if not (_is_map_style(ds) or hasattr(ds, "__iter__")):
                raise TypeError(f"Dataset {ds!r} is neither map-style nor iterable")
        self._iterators: dict[int, Iterator] = {}
        # generators are not re-entrant, and the consumption counters must not race
        self._iter_lock = threading.Lock()
        # per-stream consumption counters, monotonic across iterator resets,
        # so create_ids() never collides
        self._consumed: dict[int, int] = {}
        self._cumulative_sizes = np.cumsum(
            [self._dataset_len(ds) for ds in self.datasets]).tolist()

    def __getstate__(self) -> dict:
        # worker processes pickle the dataset: not the lock or live iterators
        state = dict(self.__dict__)
        state["_iter_lock"] = None
        state["_iterators"] = {}
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._iter_lock = threading.Lock()

    @staticmethod
    def _dataset_len(dataset: Any) -> int:
        if _is_map_style(dataset):
            return len(dataset)
        # an iterable with no length holds one slot, consumed again and again
        if hasattr(dataset, "__len__"):
            try:
                return len(dataset)
            except TypeError:
                return 1
        return 1

    def __len__(self) -> int:
        return int(self._cumulative_sizes[-1])

    @property
    def all_map_style(self) -> bool:
        """True when every sub-dataset (recursively) is map-style: a fetch
        then has no side effect, so a loader may skip fetches (the resumed
        epoch's fast-forward). An iterable sub-dataset advances on every
        ``__getitem__``."""
        return all(ds.all_map_style if hasattr(ds, "all_map_style") else _is_map_style(ds)
                   for ds in self.datasets)

    @property
    def cumulative_sizes(self) -> list[int]:
        return list(self._cumulative_sizes)

    def set_epoch(self, epoch: int) -> None:
        """Propagate the epoch to the sub-datasets and drop cached iterators
        (a stream's new order takes effect at its next ``iter()``)."""
        with self._iter_lock:
            self._iterators.clear()
        for ds in self.datasets:
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def _next_from_iterable(self, dataset_idx: int) -> Example:
        if dataset_idx not in self._iterators:
            self._iterators[dataset_idx] = iter(self.datasets[dataset_idx])
        try:
            return next(self._iterators[dataset_idx])
        except StopIteration:
            self._iterators[dataset_idx] = iter(self.datasets[dataset_idx])
            return next(self._iterators[dataset_idx])

    def __getitem__(self, idx: int) -> Example:
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(f"Index {idx} out of range for size {len(self)}")
        dataset_idx = bisect.bisect_right(self._cumulative_sizes, idx)
        sample_idx = idx - (self._cumulative_sizes[dataset_idx - 1] if dataset_idx > 0 else 0)
        dataset = self.datasets[dataset_idx]
        if _is_map_style(dataset):
            example = dataset[sample_idx]
            fallback_index = sample_idx
        else:
            with self._iter_lock:
                example = self._next_from_iterable(dataset_idx)
                fallback_index = self._consumed.get(dataset_idx, 0)
                self._consumed[dataset_idx] = fallback_index + 1
        if not isinstance(example, Example):
            raise TypeError(f"Expected datasets to return Example, got "
                            f"{type(example).__name__} from dataset {dataset_idx}")
        example[DATASET_INDEX_KEY] = dataset_idx
        if EXAMPLE_INDEX_KEY not in example:
            # a stream knows no global index: its consumption order stands in
            example[EXAMPLE_INDEX_KEY] = fallback_index
        example.create_ids()
        return example
