"""Corpus materialization: decode and preprocess once into packed TFRecord
shards, a counterpart of :mod:`mmlearn_tpu.datasets.materialize`
(``encode_packed`` :64, ``decode_packed`` :88, ``packed_to_example`` :115,
``materialize`` :128, ``MaterializedDataset`` :240): the same shard files,
byte for byte, from the same samples.

The expensive host work (JPEG decode, resize, tokenization) runs a single
time; the result persists as TFRecord shards of *packed tensors* (raw
little-endian bytes + shape/dtype sidecar features), and training reads
those: a sample's read is ``pread + CRC-32C + np.frombuffer`` (a memcpy).

Packed-tensor convention (one ``tf.train.Example`` per sample):

- every ndarray leaf ``k`` is stored as three features:
  ``k`` = BytesList[raw C-order little-endian bytes],
  ``k/shape`` = Int64List, ``k/dtype`` = BytesList[dtype.str, e.g. b'<f4'];
- bytes/str leaves pass through as BytesList;
- python int leaves pass through as Int64List scalars.

:func:`decode_packed` inverts the convention; :func:`packed_to_example`
plugs into :class:`~mmlearn_tpu_torch.datasets.core.tfrecord.TFRecordDataset`
as ``to_example`` so a materialized corpus composes with samplers, ratio
sampling and the collator like any map-style dataset.

Multi-process: :func:`materialize` writes shards round-robin by shard
index; pass ``rank``/``world_size`` to split the work across processes
(each process owns a disjoint set of shard files, so there is no write
coordination). With a map-style source or a ``samples_for_shard`` factory
each process touches only its ~N/W samples; a one-shot iterator is the
documented exception (full consumption per process, encode cost skipped).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

import numpy as np

from mmlearn_tpu_torch.datasets.core.example import Example
from mmlearn_tpu_torch.datasets.core.tfrecord import (
    TFRecordDataset,
    encode_tf_example,
    write_tfrecord,
)

__all__ = [
    "encode_packed",
    "decode_packed",
    "packed_to_example",
    "materialize",
    "MaterializedDataset",
]

_SHAPE = "/shape"
_DTYPE = "/dtype"


def encode_packed(sample: Mapping[str, Any]) -> bytes:
    """One sample (flat ``{key: ndarray|bytes|str|int}``) → serialized
    ``tf.train.Example`` under the packed-tensor convention."""
    feats: dict[str, Any] = {}
    for key, value in sample.items():
        if _SHAPE in key or _DTYPE in key:
            raise ValueError(f"key {key!r} collides with packed sidecars")
        if isinstance(value, (bytes, str)):
            feats[key] = value
            continue
        if isinstance(value, (bool, int, np.integer)):
            feats[key] = int(value)
            continue
        arr = np.asarray(value)
        if arr.dtype == object:
            raise TypeError(f"cannot pack object-dtype leaf {key!r}")
        # canonical little-endian C-order bytes: readable on any host
        arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
        feats[key] = arr.tobytes()
        feats[key + _SHAPE] = np.asarray(arr.shape, np.int64)
        feats[key + _DTYPE] = arr.dtype.str.encode()
    return encode_tf_example(feats)


def decode_packed(features: Mapping[str, Any]) -> dict[str, Any]:
    """Parsed feature dict → ``{key: ndarray|bytes|int}`` (inverts
    :func:`encode_packed`). Zero-decode: each tensor is one frombuffer view
    copied into a writable array (a single memcpy)."""
    out: dict[str, Any] = {}
    for key, value in features.items():
        if key.endswith(_SHAPE) or key.endswith(_DTYPE):
            continue
        shape = features.get(key + _SHAPE)
        if shape is not None:
            dtype = np.dtype(features[key + _DTYPE][0].decode())
            raw = value[0] if isinstance(value, list) else value
            arr = np.frombuffer(raw, dtype=dtype).reshape(
                tuple(int(d) for d in shape)
            )
            # writable copy: downstream transforms/collators may mutate
            out[key] = np.array(arr)
            continue
        if isinstance(value, list) and len(value) == 1:
            out[key] = value[0]
        elif isinstance(value, np.ndarray) and value.shape == (1,):
            out[key] = value.item()
        else:
            out[key] = value
    return out


def packed_to_example(features: Mapping[str, Any]) -> Example:
    """``to_example`` adapter for :class:`TFRecordDataset` over a
    materialized corpus."""
    return Example(decode_packed(features))


@dataclass
class MaterializeResult:
    shards: list[str]
    num_samples: int
    num_bytes: int


def materialize(
    samples: Any = None,
    output_dir: str = "",
    *,
    prefix: str = "train",
    shard_size: int = 1024,
    to_features: Optional[Callable[[Any], Mapping[str, Any]]] = None,
    rank: int = 0,
    world_size: int = 1,
    num_samples: Optional[int] = None,
    samples_for_shard: Optional[Callable[[int, int, int], Iterable]] = None,
) -> MaterializeResult:
    """Write ``samples`` as packed TFRecord shards under ``output_dir``.

    Args:
        samples: map-style source (``__len__`` + ``__getitem__``) or
            iterable of flat sample dicts (or anything, with
            ``to_features`` mapping each item to one). An :class:`Example`
            works as-is (it is a Mapping).
        output_dir: created if missing; shards are named
            ``{prefix}-{i:05d}.tfrecord``.
        shard_size: samples per shard.
        to_features: optional per-item adapter run before packing (e.g.
            apply the train transform once, drop unused keys).
        rank/world_size: this process writes only shards where
            ``shard_index % world_size == rank``. Disjoint files — no write
            coordination needed. Per-process COST is ~N/W for map-style
            sources and for ``samples_for_shard`` (non-owned samples are
            never fetched); a plain one-shot iterator is the documented
            exception — it must be consumed in full on every process to
            keep shard boundaries aligned (only the encode cost is skipped),
            so prefer the other two forms for large corpora.
        num_samples: total corpus size; required with ``samples_for_shard``,
            inferred via ``len`` otherwise.
        samples_for_shard: optional factory
            ``(shard_idx, start, stop) -> iterable of samples`` for sources
            that can seek (HDF5 ranges, per-shard files): each process
            calls it only for its own shards.
    """
    os.makedirs(output_dir, exist_ok=True)
    shards: list[str] = []
    num_bytes = 0

    def _pack(item: Any) -> bytes:
        feats = to_features(item) if to_features is not None else item
        return encode_packed(feats)

    def _write_shard(shard_idx: int, packed: Iterable[bytes]) -> None:
        nonlocal num_bytes
        path = os.path.join(output_dir, f"{prefix}-{shard_idx:05d}.tfrecord")
        write_tfrecord(path, packed)
        shards.append(path)
        num_bytes += os.path.getsize(path)

    # -- seekable sources: touch ONLY this rank's ~N/W samples -------------
    if samples_for_shard is not None or hasattr(samples, "__getitem__"):
        if samples_for_shard is not None:
            if num_samples is None:
                raise ValueError(
                    "materialize(samples_for_shard=...) requires num_samples"
                )
            total = int(num_samples)
        else:
            total = int(num_samples if num_samples is not None else len(samples))
        # an empty source writes no shard files (a zero-record .tfrecord
        # would still be globbed by downstream consumers)
        n_shards = -(-total // shard_size)
        for shard_idx in range(n_shards):
            if shard_idx % world_size != rank:
                continue
            start = shard_idx * shard_size
            stop = min(start + shard_size, total)
            if samples_for_shard is not None:
                items: Iterable[Any] = samples_for_shard(shard_idx, start, stop)
            else:
                items = (samples[i] for i in range(start, stop))
            _write_shard(shard_idx, (_pack(it) for it in items))
        return MaterializeResult(
            shards=shards, num_samples=total, num_bytes=num_bytes
        )

    # -- one-shot iterator fallback: full consumption per process ----------
    count = 0
    buf: list[Any] = []
    shard_idx = 0

    def _flush() -> None:
        nonlocal buf, shard_idx
        if buf and shard_idx % world_size == rank:
            _write_shard(shard_idx, iter(buf))
        buf = []
        shard_idx += 1

    for item in samples:
        # non-owned items are only counted — their production cost is
        # already paid by the iterator (the documented limitation of this
        # form). Owned items are packed IMMEDIATELY: generators commonly
        # yield views into a reused buffer, so deferring the encode to
        # flush time would serialize the buffer's final contents
        # shard_size times over
        buf.append(_pack(item) if shard_idx % world_size == rank else None)
        count += 1
        if len(buf) >= shard_size:
            _flush()
    if buf:
        _flush()
    return MaterializeResult(
        shards=shards, num_samples=count, num_bytes=num_bytes
    )


def MaterializedDataset(
    shards: Sequence[str], verify_crc: bool = False
) -> TFRecordDataset:
    """Map-style dataset over a materialized corpus: TFRecordDataset with
    the packed-tensor decoder plugged in."""
    return TFRecordDataset(
        shards, to_example=packed_to_example, verify_crc=verify_crc
    )
