"""The process loader, a counterpart of
:mod:`mmlearn_tpu.datasets.core.grain_loader` (``GrainDataLoader`` :40,
``_collate`` :128): the same map-style dataset, sampler and collator as the
thread :class:`~mmlearn_tpu_torch.datasets.core.loader.DataLoader`, with
examples fetched and collated in worker processes, for decode work that
holds the interpreter lock (JPEG decode, tokenization). Its batches equal
the thread loader's, batch for batch: the same order, the same padding of
a partial last batch and the same ``batch_validity`` mask.

Where the JAX package runs grain's workers, the port runs
``torch.utils.data.DataLoader``'s: the sampler draws each epoch's indices
in this process and hands them to the workers in batches, each worker
fetches and collates a whole batch, and batches come back in order, their
arrays through shared memory (as tensors, numpy again on arrival). The
workers start by ``spawn`` (a process with CUDA up or with threads must
not ``fork``), so the dataset, its transform and the collator must be
picklable, and stay up across epochs: each index carries its epoch, and a
worker passes a new epoch to its copy of the dataset's ``set_epoch``
before it fetches.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.datasets.core.data_collator import DefaultDataCollator
from mmlearn_tpu_torch.datasets.core.loader import _BATCH_VALIDITY_KEY, _propagate_set_epoch
from mmlearn_tpu_torch.datasets.core.samplers import RandomSampler, SequentialSampler


class _EpochIndexed:
    """The dataset as the workers see it: ``(epoch, index)`` -> the example,
    with ``set_epoch`` propagated to the dataset when the epoch changes."""

    def __init__(self, dataset: Any) -> None:
        self.dataset = dataset
        self.epoch: Optional[int] = None

    def __getitem__(self, key: tuple[int, int]) -> Any:
        epoch, idx = key
        if epoch != self.epoch:
            _propagate_set_epoch(self.dataset, epoch)
            self.epoch = epoch
        return self.dataset[idx]


class _Batches:
    """The batch sampler of the torch loader: the current epoch's index
    batches, re-read on every pass."""

    def __init__(self) -> None:
        self.batches: list[list[tuple[int, int]]] = []

    def __iter__(self) -> Iterator[list[tuple[int, int]]]:
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class _Collate:
    """Pad a partial batch with its last example, collate, and mark the
    padding in ``batch_validity``, as the thread loader does. In a worker,
    the batch's numeric arrays leave as tensors, whose storage torch moves
    to shared memory, so that a batch crosses to the main process as
    handles rather than through the result pipe."""

    def __init__(self, collate_fn: Callable, batch_size: int, pad: bool,
                 shared: bool = False) -> None:
        self.collate_fn, self.batch_size, self.pad = collate_fn, batch_size, pad
        self.shared = shared

    def __call__(self, examples: list) -> dict[str, Any]:
        n_real = len(examples)
        if self.pad and n_real < self.batch_size:
            examples = examples + [examples[-1]] * (self.batch_size - n_real)
        out = self.collate_fn(examples)
        if self.pad:
            validity = np.zeros(len(examples), dtype=bool)
            validity[:n_real] = True
            out[_BATCH_VALIDITY_KEY] = validity
        if self.shared:
            import torch

            out = {k: torch.from_numpy(v) if _numeric(v) else v for k, v in out.items()}
        return out


def _numeric(value: Any) -> bool:
    return isinstance(value, np.ndarray) and value.dtype.kind in "biuf"


def _to_numpy(batch: dict[str, Any]) -> dict[str, Any]:
    """A batch from the workers with its tensors back as numpy arrays
    (views of the shared memory)."""
    import torch

    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


@store(group="dataloader", name="GrainDataLoader", populate_full_signature=False)
class GrainDataLoader:
    """Multiprocess loader with the same interface as ``DataLoader``; with
    ``num_workers=0`` it fetches in this process."""

    def __init__(
        self,
        dataset: Any = None,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler: Optional[Any] = None,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 4,
        prefetch_factor: int = 2,
        pad_partial_batches: bool = False,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.pad_partial_batches = pad_partial_batches
        self.collate_fn = collate_fn or DefaultDataCollator()
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(1, int(prefetch_factor))
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, seed=seed)
        else:
            self.sampler = SequentialSampler(dataset)
        if self.num_workers > 0 and not getattr(dataset, "all_map_style", True):
            # each worker holds a pickled copy: an iterable sub-dataset's
            # stream would restart in every worker, its head read
            # num_workers times and its tail never
            raise ValueError(
                "GrainDataLoader(num_workers>0) cannot multiprocess a dataset with "
                "iterable/streaming sub-datasets (each worker would replay the stream "
                "from the start). Use num_workers=0 or the threaded DataLoader.")
        self.epoch = 0
        self._batches = _Batches()
        self._loader = None  # the torch loader, made at the first pass

    def set_epoch(self, epoch: int) -> None:
        """Set the sampler's epoch and the datasets' (this process's copy at
        once, the workers' at their next fetch)."""
        self.epoch = int(epoch)
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        _propagate_set_epoch(self.dataset, epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _torch_loader(self):
        if self._loader is None:
            from torch.utils.data import DataLoader as TorchLoader

            workers = {}
            if self.num_workers > 0:
                workers = {"multiprocessing_context": "spawn", "persistent_workers": True,
                           "prefetch_factor": self.prefetch_factor}
            self._loader = TorchLoader(
                _EpochIndexed(self.dataset), batch_sampler=self._batches,
                collate_fn=_Collate(self.collate_fn, self.batch_size, self.pad_partial_batches,
                                    shared=self.num_workers > 0),
                num_workers=self.num_workers, **workers)
        return self._loader

    def close(self) -> None:
        """Drop the torch loader: its workers stop once nothing else holds
        its iterator."""
        self._loader = None

    def __iter__(self) -> Iterator[dict[str, Any]]:
        indices = [(self.epoch, int(i)) for i in self.sampler]
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if batches and self.drop_last and len(batches[-1]) < self.batch_size:
            batches.pop()
        self._batches.batches = batches
        if self.num_workers == 0:
            return iter(self._torch_loader())
        return map(_to_numpy, self._torch_loader())
