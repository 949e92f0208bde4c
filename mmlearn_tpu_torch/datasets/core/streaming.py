"""Streaming (iterable) datasets with multi-process shard assignment, a
counterpart of :mod:`mmlearn_tpu.datasets.core.streaming`
(``StreamingDataset`` :36, ``jsonl_open_shard`` :144): the same shard
order, assignment and shuffle buffer for the same seed, rank, world size
and epoch.

- shards are assigned round-robin ``shards[rank::world_size]`` so every
  process reads a disjoint subset. ``rank`` and ``world_size`` default to
  the global mesh's batch shards, else ``torch.distributed``'s where a
  process group is up, else 0 and 1, the rule of the port's samplers (the JAX package asks
  ``jax.process_index()`` and ``jax.process_count()``);
- shard *order* reshuffles per epoch from ``(seed, epoch)`` -- ``set_epoch``
  follows the sampler protocol and is propagated by ``DataLoader``;
- an optional bounded shuffle buffer decorrelates examples within a shard
  stream without unbounded memory;
- ``infinite=True`` re-opens the stream with epoch auto-incremented, for
  step-based (rather than epoch-based) training loops.

The iterator protocol matches what ``CombinedDataset`` consumes (any object
with ``__iter__`` yielding ``Example``), so streaming and map-style datasets
combine freely.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.datasets.core.example import Example
from mmlearn_tpu_torch.datasets.core.samplers import _default_rank_and_replicas


@store(group="datasets", name="StreamingDataset", populate_full_signature=False)
class StreamingDataset:
    """Iterate examples from the shard subset owned by this process.

    Args:
        shards: the full (global) list of shard descriptors — file paths,
            URLs, or any objects ``open_shard`` understands. Every process
            must pass the SAME list in the same order.
        open_shard: callable mapping one shard descriptor to an iterator of
            :class:`Example` (or dicts, passed through unchanged).
        shuffle_shards: reshuffle the shard order each epoch (seeded).
        shuffle_buffer: if > 0, examples pass through a bounded reservoir
            that emits a uniformly-shuffled stream.
        seed: base seed; the effective stream order is a pure function of
            ``(seed, epoch, rank)``.
        rank / world_size: shard-assignment coordinates; default to the
            global mesh's batch shards, else ``torch.distributed``'s rank
            and world size where a process group is up, else 0 and 1.
        infinite: loop forever, auto-advancing the epoch at each wrap so
            every pass sees a fresh shuffle.
    """

    def __init__(
        self,
        shards: Sequence[Any],
        open_shard: Callable[[Any], Iterator[Any]],
        *,
        shuffle_shards: bool = True,
        shuffle_buffer: int = 0,
        seed: int = 0,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        infinite: bool = False,
        length: Optional[int] = None,
    ) -> None:
        rank, world_size = _default_rank_and_replicas(rank, world_size)
        if world_size < 1 or not (0 <= rank < world_size):
            raise ValueError(f"bad rank/world_size: {rank}/{world_size}")
        if len(shards) < world_size:
            raise ValueError(
                f"{len(shards)} shards cannot cover {world_size} processes — "
                "every process needs at least one"
            )
        self.shards = list(shards)
        self.open_shard = open_shard
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = int(shuffle_buffer)
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.infinite = infinite
        #: declared per-process example count — lets length-based planning
        #: (DataLoader batches/epoch, max_epochs) work without indexing the
        #: stream; omit for truly unbounded sources (step-based training)
        self.length = length
        self.epoch = 0

    def __len__(self) -> int:
        if self.length is None:
            raise TypeError(
                "StreamingDataset has no declared length — pass length= for "
                "epoch-based training, or drive the loop by max_steps"
            )
        return self.length

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _epoch_shards(self, epoch: int) -> list[Any]:
        order = np.arange(len(self.shards))
        if self.shuffle_shards:
            # same permutation on every process -> assignment stays disjoint
            np.random.default_rng(self.seed + epoch).shuffle(order)
        mine = order[self.rank :: self.world_size]
        return [self.shards[i] for i in mine]

    def _raw_stream(self, epoch: int) -> Iterator[Any]:
        for shard in self._epoch_shards(epoch):
            yield from self.open_shard(shard)

    def _shuffled(self, stream: Iterator[Any], epoch: int) -> Iterator[Any]:
        if self.shuffle_buffer <= 1:
            yield from stream
            return
        rng = np.random.default_rng(self.seed + epoch + 7919 * (self.rank + 1))
        buf: list[Any] = []
        for item in stream:
            buf.append(item)
            if len(buf) >= self.shuffle_buffer:
                j = int(rng.integers(len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[Any]:
        epoch = self.epoch
        while True:
            yield from self._shuffled(self._raw_stream(epoch), epoch)
            if not self.infinite:
                return
            epoch += 1


def jsonl_open_shard(
    path: str, to_example: Optional[Callable[[dict], Any]] = None
) -> Iterator[Any]:
    """Open one ``.jsonl`` shard file as an iterator of Examples.

    Each line is a JSON object; by default it becomes an :class:`Example`
    with the object's keys. Pass ``to_example`` for custom decoding
    (e.g. base64 image fields).
    """
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            yield to_example(record) if to_example else Example(record)
