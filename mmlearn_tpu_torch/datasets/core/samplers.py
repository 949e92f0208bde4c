"""Host-side samplers, counterpart of :mod:`mmlearn_tpu.datasets.core.samplers`
(``SequentialSampler`` :39, ``RandomSampler`` :55,
``CombinedDatasetRatioSampler`` :75, ``DistributedEvalSampler`` :195).

Every draw is numpy's, from ``default_rng(seed + epoch)``, in the JAX
package's order, so the same seed and epoch give the same indices. Each
replica takes the strided shard ``indices[rank::num_replicas]`` of one
global order. ``rank`` and ``num_replicas`` are passed explicitly; where
they are not, they are the global mesh's batch shards (``dp_rank`` of
``data x fsdp``: the ranks of a ``seq`` or ``model`` group read the same
rows) where one is set, else ``torch.distributed``'s rank and world where it
is initialized, else 0 and 1 (the JAX package asks ``jax.process_index()``).
"""

from __future__ import annotations

import math
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.datasets.core.combined_dataset import CombinedDataset


def _default_rank_and_replicas(
    rank: Optional[int], num_replicas: Optional[int]
) -> tuple[int, int]:
    if rank is not None and num_replicas is not None:
        return rank, num_replicas
    import torch.distributed as dist

    from mmlearn_tpu_torch.parallel.mesh import peek_global_mesh

    mesh = peek_global_mesh()
    if mesh is not None and mesh.device_mesh is not None:
        default_rank, default_world = mesh.dp_rank, mesh.dp_size
    elif dist.is_available() and dist.is_initialized():
        default_rank, default_world = dist.get_rank(), dist.get_world_size()
    else:
        default_rank, default_world = 0, 1
    return (rank if rank is not None else default_rank,
            num_replicas if num_replicas is not None else default_world)


class SequentialSampler:
    """Yield ``range(len(dataset))``."""

    def __init__(self, dataset: Any) -> None:
        self.dataset = dataset

    def __iter__(self) -> Iterator[int]:
        return iter(range(len(self.dataset)))

    def __len__(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        """Nothing: the order does not depend on the epoch."""


class RandomSampler:
    """A permutation drawn from ``default_rng(seed + epoch)``."""

    def __init__(self, dataset: Any, seed: int = 0) -> None:
        self.dataset = dataset
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(len(self.dataset)).tolist())

    def __len__(self) -> int:
        return len(self.dataset)


@store(group="dataloader/sampler", name="CombinedDatasetRatioSampler")
class CombinedDatasetRatioSampler:
    """Weighted sampling across the sub-datasets of a :class:`CombinedDataset`.

    Each epoch: multinomial draw counts a sub-dataset from the normalized
    ratios (by default each sub-dataset's length), indices drawn in each
    (with replacement, or where the count exceeds its size), padded or cut
    to a ``total_size`` divisible by ``num_replicas``, shuffled, then the
    rank's strided shard.
    """

    def __init__(
        self,
        dataset: Optional[CombinedDataset] = None,
        ratios: Optional[Sequence[float]] = None,
        num_samples: Optional[int] = None,
        replacement: bool = False,
        shuffle: bool = True,
        rank: Optional[int] = None,
        num_replicas: Optional[int] = None,
        drop_last: bool = False,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.ratios = list(ratios) if ratios is not None else None
        self._requested_num_samples = num_samples
        self.replacement = replacement
        self.shuffle = shuffle
        self.rank, self.num_replicas = _default_rank_and_replicas(rank, num_replicas)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if dataset is not None:
            self._validate()

    def _validate(self) -> None:
        if not isinstance(self.dataset, CombinedDataset):
            raise TypeError("CombinedDatasetRatioSampler requires a CombinedDataset, got "
                            f"{type(self.dataset).__name__}")
        n = len(self.dataset.datasets)
        if self.ratios is None:
            # size-proportional: uniform ratios would oversample small datasets
            self.ratios = [float(CombinedDataset._dataset_len(ds)) for ds in self.dataset.datasets]
        if len(self.ratios) != n:
            raise ValueError(f"Got {len(self.ratios)} ratios for {n} datasets")
        total = float(sum(self.ratios))
        self.ratios = [r / total for r in self.ratios]

    @property
    def total_num_samples(self) -> int:
        n = (self._requested_num_samples if self._requested_num_samples is not None
             else len(self.dataset))
        if self.drop_last:
            return (n // self.num_replicas) * self.num_replicas
        return int(math.ceil(n / self.num_replicas)) * self.num_replicas

    @property
    def num_samples(self) -> int:
        return self.total_num_samples // self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch, and propagate it to the sub-datasets that take one."""
        self.epoch = epoch
        for ds in self.dataset.datasets:
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def _global_indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch)
        total = self.total_num_samples
        counts = rng.multinomial(total, self.ratios)
        cumsizes = [0] + self.dataset.cumulative_sizes
        chunks = []
        for ds_idx, count in enumerate(counts):
            lo, hi = cumsizes[ds_idx], cumsizes[ds_idx + 1]
            size = hi - lo
            if count == 0 or size == 0:
                continue
            if self.replacement or count > size:
                draws = rng.integers(0, size, size=count)
            else:
                draws = rng.permutation(size)[:count]
            chunks.append(draws + lo)
        indices = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
        if len(indices) < total:  # pad to exactly total_size
            pad = indices[: total - len(indices)]
            while len(indices) + len(pad) < total and len(indices) > 0:
                pad = np.concatenate([pad, indices])[: total - len(indices)]
            indices = np.concatenate([indices, pad])
        indices = indices[:total]
        if self.shuffle:
            rng.shuffle(indices)
        return indices

    def __iter__(self) -> Iterator[int]:
        return iter(self._global_indices()[self.rank :: self.num_replicas].tolist())

    def __len__(self) -> int:
        return self.num_samples


@store(group="dataloader/sampler", name="DistributedEvalSampler")
class DistributedEvalSampler:
    """Unpadded distributed sampler for exact evaluation: ranks may see
    different numbers of examples, so it is for evaluation only."""

    def __init__(
        self,
        dataset: Optional[Any] = None,
        shuffle: bool = False,
        rank: Optional[int] = None,
        num_replicas: Optional[int] = None,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.shuffle = shuffle
        self.rank, self.num_replicas = _default_rank_and_replicas(rank, num_replicas)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _global_indices(self) -> np.ndarray:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(indices)
        return indices

    def __iter__(self) -> Iterator[int]:
        return iter(self._global_indices()[self.rank :: self.num_replicas].tolist())

    def __len__(self) -> int:
        total = len(self.dataset)
        return (total - self.rank + self.num_replicas - 1) // self.num_replicas
