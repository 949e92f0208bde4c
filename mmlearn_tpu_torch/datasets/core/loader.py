"""The host loader and the device feeder, counterpart of
:mod:`mmlearn_tpu.datasets.core.loader` (``DataLoader`` :42-208,
``DeviceFeeder`` :211-350).

:class:`DataLoader` is host code with the JAX package's semantics: fixed
batch shapes (``drop_last``, or ``pad_partial_batches`` with a
``batch_validity`` mask), a thread pool that fetches examples, a bounded
prefetch thread for collated numpy batches, ``set_epoch`` propagated to the
sampler and the datasets, and :meth:`DataLoader.iter_from_batch`, the
fast-forward of a resumed epoch.

:class:`DeviceFeeder` moves host batches to the card off the compute
stream. Its producer thread drains a source of host batches and, for each,
copies every numpy array into a page-locked staging buffer of its own
(a ring of ``prefetch + 2`` buffers a key, each reused only after the event
recorded behind its last copy has completed), starts the host-to-device
copy with ``non_blocking=True`` on the feeder's own CUDA stream, runs
``normalize`` on that stream, and records an event behind the batch. The
consumer makes its current stream wait on that event before it reads the
batch and marks every device tensor of the batch as used by its stream
(``record_stream``), so the caching allocator cannot hand the memory on
while the step still reads it. Tensors already on the device pass through
without a copy. On the CPU a numpy array becomes a tensor by
``torch.from_numpy``, with no pinning and no stream.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Mapping, Optional

import numpy as np
import torch

from mmlearn_tpu_torch.datasets.core.data_collator import DefaultDataCollator
from mmlearn_tpu_torch.datasets.core.samplers import RandomSampler, SequentialSampler

#: how long an early close of an iterator waits, at most, for its prefetch
#: thread to finish the fetch it is in (a fetch of ``batch_size`` examples)
CLOSE_TIMEOUT_S = 60.0

_BATCH_VALIDITY_KEY = "batch_validity"


def _propagate_set_epoch(dataset: Any, epoch: int) -> None:
    """Call ``set_epoch`` on a dataset, or else on its sub-datasets."""
    if dataset is None:
        return
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
        return  # a container that owns set_epoch handles its own children
    for sub in getattr(dataset, "datasets", []):
        _propagate_set_epoch(sub, epoch)


def _drain(q: queue.Queue) -> None:
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


class DataLoader:
    """Iterate a map-style dataset in collated, fixed-size numpy batches."""

    def __init__(
        self,
        dataset: Any = None,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler: Optional[Any] = None,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        prefetch_factor: int = 2,
        pad_partial_batches: bool = False,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.pad_partial_batches = pad_partial_batches
        self.collate_fn = collate_fn or DefaultDataCollator()
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(1, int(prefetch_factor))
        self._pool: Optional[ThreadPoolExecutor] = None
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, seed=seed)
        else:
            self.sampler = SequentialSampler(dataset)

    def set_epoch(self, epoch: int) -> None:
        """Set the sampler's epoch and the datasets' (streams reshuffle)."""
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        _propagate_set_epoch(self.dataset, epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, skip: int = 0) -> Iterator[list[int]]:
        """Batch index lists; the first ``skip`` batches are drawn from the
        sampler (its order is kept) but not yielded."""
        produced = 0
        batch: list[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                if produced >= skip:
                    yield batch
                produced += 1
                batch = []
        if batch and not self.drop_last and produced >= skip:
            yield batch

    def _fetch(self, indices: list[int]) -> dict[str, Any]:
        if self.num_workers > 0 and len(indices) > 1:
            if self._pool is None:  # one pool a loader, reused across batches
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            examples = list(self._pool.map(self.dataset.__getitem__, indices))
        else:
            examples = [self.dataset[i] for i in indices]
        n_real = len(examples)
        if self.pad_partial_batches and n_real < self.batch_size:
            examples = examples + [examples[-1]] * (self.batch_size - n_real)
        batch = self.collate_fn(examples)
        if self.pad_partial_batches:
            validity = np.zeros(len(examples), dtype=bool)
            validity[:n_real] = True
            batch[_BATCH_VALIDITY_KEY] = validity
        return batch

    def _iter_sync(self, skip: int = 0) -> Iterator[dict[str, Any]]:
        for indices in self._index_batches(skip):
            yield self._fetch(indices)

    def _iter_prefetch(self, skip: int = 0) -> Iterator[dict[str, Any]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        error_box: list[BaseException] = []
        stop = threading.Event()

        def producer() -> None:
            try:
                for indices in self._index_batches(skip):
                    if stop.is_set():
                        return
                    batch = self._fetch(indices)
                    # a bounded put: an abandoned consumer (a break at a
                    # limit) must not block this thread on a full queue
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as err:  # raised again in the consumer
                error_box.append(err)
            finally:
                # a consumer still reading must get the sentinel; only an
                # abandoned one (stop set) may miss it
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, name="DataLoader prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            thread.join()
            if error_box:
                raise error_box[0]
        finally:
            # closed early: release the producer, drain the queue, and wait
            # for the fetch it may be in, so that none follows the close
            stop.set()
            _drain(q)
            thread.join(CLOSE_TIMEOUT_S)
            _drain(q)

    def _can_fast_skip(self) -> bool:
        # opt-in only: an unknown dataset's __getitem__ may have side effects
        return bool(getattr(self.dataset, "all_map_style", False))

    def iter_from_batch(self, start: int) -> Optional[Iterator[dict[str, Any]]]:
        """This epoch's batches from batch ``start`` on, without fetching the
        skipped examples: their sampler indices are still drawn, so the
        order is an uninterrupted epoch's. ``None`` where the dataset
        consumes streams on ``__getitem__``: the caller then fetches and
        discards, so that stream positions stay right."""
        start = int(start)
        if start <= 0:
            return iter(self)
        if not self._can_fast_skip():
            return None
        return self._dispatch(start)

    def _dispatch(self, skip: int = 0) -> Iterator[dict[str, Any]]:
        if self.num_workers > 0 or self.prefetch_factor > 1:
            return self._iter_prefetch(skip)
        return self._iter_sync(skip)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return self._dispatch()


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a batch (mappings, lists and tuples, recursively)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class DeviceFeeder:
    """A producer thread that places host batches on ``device`` ahead of the
    consumer (see the module docstring).

    Args:
        source: an iterable of host batches: mappings, lists and tuples of
            numpy arrays, tensors and other values. Numeric numpy arrays
            and host tensors are placed; tensors already on ``device`` and
            every other value (strings, python numbers) pass through.
        device: where the batches go; ``"cuda"`` by default. A feeder for a
            CUDA device raises if CUDA is absent, and its producer raises
            (in the consumer) if a staging buffer cannot be pinned.
        normalize: applied to each placed batch, on the feeder's stream.
        prefetch: the queue's bound, in placed batches.
        timeout_s: the consumer's wait bound for one batch: a dead producer
            or a stalled source raises ``TimeoutError``.
        device_put: where given, ``device_put(item, place)`` places one item
            of ``source``, calling ``place`` (the feeder's placement of a
            batch) on what goes to the device; by default ``place(item)``.
            It runs on the feeder's stream.

    The feeder keeps no reference to a batch after yielding it. ``wait_s``
    is the consumer's total wait on the queue.
    """

    _SENTINEL = object()

    def __init__(
        self,
        source: Any,
        device: torch.device | str = "cuda",
        normalize: Optional[Callable[[Any], Any]] = None,
        prefetch: int = 2,
        timeout_s: float = 300.0,
        device_put: Optional[Callable[[Any, Callable[[Any], Any]], Any]] = None,
    ) -> None:
        self.device = torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._consumer_stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"DeviceFeeder for {self.device}: CUDA is not available")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
            self._consumer_stream = torch.cuda.current_stream(self.device)
        elif self.device.type != "cpu":
            raise ValueError(f"DeviceFeeder places on 'cuda' or 'cpu', not {self.device}")
        self._source = source
        self._normalize = normalize
        self._device_put = device_put
        self._prefetch = max(1, int(prefetch))
        self._timeout_s = float(timeout_s)
        self._queue: queue.Queue = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # staging: per key path a ring of [pinned buffer, event of its last copy]
        self._depth = self._prefetch + 2
        self._rings: dict[tuple, list[list]] = {}
        self._cursors: dict[tuple, int] = {}
        self._in_use: list[list] = []
        self.wait_s = 0.0

    # -- placement (producer thread) ------------------------------------------
    def _staged(self, path: tuple, src: np.ndarray | torch.Tensor) -> torch.Tensor:
        """``src`` copied into the next pinned buffer of ``path``'s ring,
        then to the card without blocking, on the current (feeder's) stream."""
        dtype = src.dtype if isinstance(src, torch.Tensor) else torch.from_numpy(
            np.empty(0, src.dtype)).dtype
        ring = self._rings.setdefault(path, [])
        i = self._cursors.get(path, 0)
        self._cursors[path] = (i + 1) % self._depth
        if i == len(ring):
            ring.append([None, None])
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()  # its last copy to the card has completed
        buf = slot[0]
        if buf is None or buf.shape != tuple(src.shape) or buf.dtype != dtype:
            buf = torch.empty(tuple(src.shape), dtype=dtype, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("DeviceFeeder: a staging buffer could not be pinned")
            slot[0] = buf
        if isinstance(src, torch.Tensor):
            buf.copy_(src)
        else:
            np.copyto(buf.numpy(), src, casting="no")
        slot[1] = None
        self._in_use.append(slot)
        return buf.to(self.device, non_blocking=True)

    def place(self, tree: Any, path: tuple = ()) -> Any:
        """One batch on the feeder's device (see the class docstring)."""
        if isinstance(tree, Mapping):
            return {k: self.place(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            placed = [self.place(v, path + (i,)) for i, v in enumerate(tree)]
            return placed if isinstance(tree, list) else tuple(placed)
        if isinstance(tree, np.ndarray) and tree.dtype.kind in "biufc":
            if self._stream is None:
                shared = tree.flags.c_contiguous and tree.flags.writeable
                return torch.from_numpy(tree if shared else tree.copy())
            return self._staged(path, tree)
        if isinstance(tree, torch.Tensor) and self._stream is not None and not tree.is_cuda:
            return self._staged(path, tree)
        return tree

    def _place_item(self, item: Any) -> tuple[Any, Optional[torch.cuda.Event]]:
        if self._stream is None:
            out = self.place(item) if self._device_put is None else self._device_put(item, self.place)
            return (out if self._normalize is None else self._normalize(out)), None
        resident = [t for t in _tensors(item) if t.is_cuda]
        if resident:
            # the feeder's stream reads tensors made on other streams: after
            # their producers, and their memory kept until it has read them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._stream.wait_stream(self._consumer_stream)
            for t in resident:
                t.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            out = self.place(item) if self._device_put is None else self._device_put(item, self.place)
            if self._normalize is not None:
                out = self._normalize(out)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        for slot in self._in_use:
            slot[1] = ready
        self._in_use.clear()
        return out, ready

    def _producer(self) -> None:
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)  # the current device is per thread
            for host_item in self._source:
                if self._stop.is_set():
                    return
                placed = self._place_item(host_item)
                del host_item
                # a bounded put with re-checks: an abandoned consumer (a
                # break at max_steps or a limit) must not block this thread
                while not self._stop.is_set():
                    try:
                        self._queue.put(placed, timeout=0.1)
                        del placed
                        break
                    except queue.Full:
                        continue
                else:
                    return
            end: Any = self._SENTINEL
        except BaseException as err:  # raised in the consumer
            end = err
        while not self._stop.is_set():
            try:
                self._queue.put(end, timeout=0.1)
                break
            except queue.Full:
                continue

    # -- consumer ---------------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        self._ensure_started()
        while True:
            t0 = time.perf_counter()
            try:
                got = self._queue.get(timeout=self._timeout_s)
            except queue.Empty:
                raise TimeoutError(f"DeviceFeeder: no batch within {self._timeout_s:.0f}s "
                                   "(producer dead or source stalled)") from None
            finally:
                self.wait_s += time.perf_counter() - t0
            if got is self._SENTINEL:
                return
            if isinstance(got, BaseException):
                raise got
            item, ready = got
            del got
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for t in _tensors(item):
                    if t.is_cuda:
                        t.record_stream(stream)
            yield item
            del item  # drop the reference before blocking on the next get

    def close(self) -> None:
        """Stop the producer and drop the batches it holds."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # the source (a loader's generator, say) is finalized once the
        # producer's frame lets go of it too
        self._source = None

    def __enter__(self) -> "DeviceFeeder":
        self._ensure_started()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
