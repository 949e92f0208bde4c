"""Dependency-free TFRecord + ``tf.train.Example`` codec, a counterpart of
:mod:`mmlearn_tpu.datasets.core.tfrecord`: CRC-32C (``crc32c`` :81, the
Python table :55-76 and the native one), record framing (``read_tfrecord``
:118, ``write_tfrecord`` :140), the ``tf.train.Example`` protobuf codec
(``parse_tf_example`` :269, ``encode_tf_example`` :337), ``tfrecord_index``
:354, ``TFRecordDataset`` :417 and ``tfrecord_open_shard`` :487. The bytes
written and read are the JAX package's, and so is the index cache
(``<shard>.idx.npz``, keyed by the shard's size and mtime): either package
reads the other's records and caches.

From the public wire specifications:

- the TFRecord container framing -- ``uint64 length | uint32 masked-crc32c
  of length | data | uint32 masked-crc32c of data`` per record;
- CRC32C (Castagnoli) with TFRecord's rotation mask;
- a minimal protobuf wire-format codec for ``tf.train.Example``
  (``Features -> map<string, Feature>``; ``Feature`` = one of
  ``BytesList(1) | FloatList(2) | Int64List(3)``), both packed and
  unpacked repeated encodings on the read side.

Checksums run in the native fastloader's CRC-32C
(:func:`mmlearn_tpu_torch.native.crc32c`, built at first use without
libjpeg); ``MMLEARN_TFRECORD_PYCRC=1``, read on each call, takes the
pure-Python table instead. Where the native library cannot be built, the
checksum raises: the port does not fall back to the Python loop, which is
hundreds of times slower.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core.example import Example

__all__ = [
    "crc32c",
    "read_tfrecord",
    "write_tfrecord",
    "parse_tf_example",
    "encode_tf_example",
    "tfrecord_open_shard",
    "tfrecord_index",
    "TFRecordDataset",
]

# -- CRC32C (Castagnoli, reflected; poly 0x1EDC6F41 → reversed 0x82F63B78) ----

_CRC_TABLE = None


def _crc_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """Pure-Python CRC-32C (the reference implementation; the path taken
    under ``MMLEARN_TFRECORD_PYCRC=1``)."""
    table = _crc_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C checksum (test vector: ``crc32c(b'123456789') == 0xE3069283``)
    in the native fastloader; ``MMLEARN_TFRECORD_PYCRC=1`` takes the Python
    path."""
    if os.environ.get("MMLEARN_TFRECORD_PYCRC", "") not in ("", "0"):
        return _crc32c_py(data, crc)
    from mmlearn_tpu_torch import native

    return native.crc32c(data, crc)


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset CRC (tensorflow/io/record_writer spec)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- TFRecord container framing ----------------------------------------------


def read_tfrecord(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield the raw serialized records of one ``.tfrecord`` file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (length_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and _masked_crc(header[:8]) != length_crc:
                raise ValueError(f"{path}: corrupt record length (crc mismatch)")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"{path}: truncated record body")
            if verify_crc and _masked_crc(data) != struct.unpack("<I", footer)[0]:
                raise ValueError(f"{path}: corrupt record data (crc mismatch)")
            yield data


def write_tfrecord(path: str, records: Iterator[bytes]) -> int:
    """Write serialized records as a ``.tfrecord`` file; returns the count."""
    n = 0
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


# -- protobuf wire helpers -----------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    end = len(buf)
    while True:
        if pos >= end:
            raise ValueError("malformed protobuf: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:  # proto int64: two's complement, always 10 bytes
        value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield ``(field_number, wire_type, value)`` over one message buffer.

    Length-delimited values come back as ``bytes`` slices; varints as int;
    fixed32/64 as int.
    """
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            if pos + length > end:
                raise ValueError(
                    "malformed protobuf: length-delimited field of "
                    f"{length} bytes overruns the buffer"
                )
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # fixed32
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# -- tf.train.Example ----------------------------------------------------------


def _parse_feature(buf: bytes) -> Any:
    """One ``Feature`` message → list[bytes] | float32 array | int64 array."""
    for field, wire, value in _iter_fields(buf):
        if field == 1:  # BytesList { repeated bytes value = 1 }
            return [v for _, _, v in _iter_fields(value)]
        if field == 2:  # FloatList { repeated float value = 1 [packed] }
            chunks: list[np.ndarray] = []
            for _, fwire, fval in _iter_fields(value):
                if fwire == 2:  # packed: zero-copy view over the wire bytes
                    chunks.append(np.frombuffer(fval, "<f4", len(fval) // 4))
                else:  # unpacked fixed32
                    chunks.append(
                        np.frombuffer(struct.pack("<I", fval), "<f4")
                    )
            if not chunks:
                return np.asarray([], np.float32)
            if len(chunks) == 1:  # frombuffer views bytes read-only: copy once
                return chunks[0].astype(np.float32, copy=True)
            return np.concatenate(chunks)  # concatenate already copies
        if field == 3:  # Int64List { repeated int64 value = 1 [packed] }
            ints: list[int] = []
            for _, iwire, ival in _iter_fields(value):
                if iwire == 2:  # packed varints
                    pos = 0
                    while pos < len(ival):
                        v, pos = _read_varint(ival, pos)
                        ints.append(_to_signed64(v))
                else:
                    ints.append(_to_signed64(ival))
            return np.asarray(ints, np.int64)
    return None  # empty Feature


def parse_tf_example(data: bytes) -> dict[str, Any]:
    """Serialized ``tf.train.Example`` → ``{key: value}``.

    Values: ``list[bytes]`` (BytesList), float32 ndarray (FloatList), or
    int64 ndarray (Int64List).
    """
    out: dict[str, Any] = {}
    for field, _, features_buf in _iter_fields(data):
        if field != 1:  # Example.features
            continue
        for ffield, _, entry in _iter_fields(features_buf):
            if ffield != 1:  # Features.feature map entry
                continue
            key: Optional[str] = None
            value: Any = None
            for efield, _, evalue in _iter_fields(entry):
                if efield == 1:
                    key = evalue.decode("utf-8")
                elif efield == 2:
                    value = _parse_feature(evalue)
            if key is not None:
                out[key] = value
    return out


def _encode_feature(value: Any) -> bytes:
    inner = bytearray()
    if isinstance(value, (bytes, str)):
        value = [value]
    if isinstance(value, (list, tuple)) and (
        # an empty plain list is ambiguous — encode as an empty BytesList
        # (the list form is the bytes/str spelling; typed-but-empty numeric
        # features should be passed as empty numpy arrays)
        not value or isinstance(value[0], (bytes, str))
    ):
        blist = bytearray()
        for item in value:
            _write_delimited(
                blist, 1,
                item.encode("utf-8") if isinstance(item, str) else item,
            )
        _write_delimited(inner, 1, bytes(blist))
        return bytes(inner)
    arr = np.asarray(value)
    if arr.ndim == 0:
        arr = arr[None]
    if arr.ndim != 1:
        raise ValueError(
            f"tf.train.Example features are flat lists; got shape "
            f"{arr.shape} — ravel() and store the shape as its own feature"
        )
    if np.issubdtype(arr.dtype, np.floating):
        packed = struct.pack(f"<{arr.size}f", *arr.astype(np.float32))
        flist = bytearray()
        _write_delimited(flist, 1, packed)
        _write_delimited(inner, 2, bytes(flist))
        return bytes(inner)
    if np.issubdtype(arr.dtype, np.integer) or arr.dtype == bool:
        ivals = bytearray()
        for v in arr.astype(np.int64):
            _write_varint(ivals, int(v))
        ilist = bytearray()
        _write_delimited(ilist, 1, bytes(ivals))
        _write_delimited(inner, 3, bytes(ilist))
        return bytes(inner)
    raise TypeError(f"unsupported feature dtype {arr.dtype!r}")


def encode_tf_example(features: Mapping[str, Any]) -> bytes:
    """``{key: value}`` → serialized ``tf.train.Example`` bytes.

    Accepts bytes/str (and lists thereof), and numeric scalars/1-D arrays
    (floats → FloatList float32; ints/bools → Int64List).
    """
    fmap = bytearray()
    for key in sorted(features):  # deterministic encoding
        entry = bytearray()
        _write_delimited(entry, 1, key.encode("utf-8"))
        _write_delimited(entry, 2, _encode_feature(features[key]))
        _write_delimited(fmap, 1, bytes(entry))
    out = bytearray()
    _write_delimited(out, 1, bytes(fmap))
    return bytes(out)


def tfrecord_index(path: str, cache: bool = True) -> np.ndarray:
    """Byte-offset index of one ``.tfrecord`` file → ``(N, 2)`` uint64 of
    ``[data_offset, data_length]`` per record.

    Indexing seeks over record bodies (header-only reads), so it runs at
    directory-walk speed even for multi-GB shards; length CRCs are always
    verified (8 bytes each — catches misframed files at index time), data
    CRCs are left to read time.

    ``cache=True`` persists the index as ``<path>.idx.npz`` keyed by the
    shard's (size, mtime) — the same pattern as ``ImageNet(manifest_cache=
    True)`` — so repeat runs skip the scan. Cache write failures (read-only
    mounts) degrade silently to in-memory indexing.
    """
    stat = os.stat(path)
    cache_path = path + ".idx.npz"
    if cache:
        try:
            with np.load(cache_path) as z:
                if (
                    int(z["size"]) == stat.st_size
                    and float(z["mtime"]) == stat.st_mtime
                ):
                    return z["index"]
        except (OSError, ValueError, KeyError):
            pass
    entries = []
    size = stat.st_size
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(12)
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header @ {pos}")
            (length,) = struct.unpack("<Q", header[:8])
            if _masked_crc(header[:8]) != struct.unpack("<I", header[8:12])[0]:
                raise ValueError(
                    f"{path}: corrupt record length @ {pos} (crc mismatch)"
                )
            end = pos + 12 + length + 4
            if end > size:
                raise ValueError(f"{path}: truncated record body @ {pos}")
            entries.append((pos + 12, length))
            pos = end
            f.seek(pos)
    index = np.asarray(entries, np.uint64).reshape(-1, 2)
    if cache:
        # np.savez appends ".npz" when missing — keep the suffix on the tmp
        tmp = f"{cache_path}.tmp-{os.getpid()}.npz"
        try:
            np.savez(tmp, index=index, size=stat.st_size, mtime=stat.st_mtime)
            os.replace(tmp, cache_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return index


@store(group="datasets", name="TFRecordDataset", populate_full_signature=False)
class TFRecordDataset:
    """Map-style (random-access) dataset over TFRecord shards.

    :func:`tfrecord_open_shard` + :class:`StreamingDataset` cover sequential
    multi-host streaming; this class adds the *indexed* path so TFRecord
    shards compose with the map-style machinery — ``CombinedDataset``
    samplers, ratio sampling, ``DistributedEvalSampler``, mid-epoch resume
    fast-forwarding — exactly like the built-in image datasets.

    Args:
        shards: shard file paths (every process passes the same list).
        to_example: maps the parsed feature dict to an :class:`Example`;
            default wraps the features as-is (and stamps the global index
            under ``EXAMPLE_INDEX_KEY``).
        verify_crc: verify each record's data CRC at read time (the native
            CRC-32C makes this ~free; length CRCs are always checked at
            index time).
        index_cache: persist per-shard indexes as ``<shard>.idx.npz``.
    """

    def __init__(
        self,
        shards: Sequence[str],
        to_example: Optional[Callable[[dict], Any]] = None,
        verify_crc: bool = False,
        index_cache: bool = True,
    ) -> None:
        if not shards:
            raise ValueError("TFRecordDataset needs at least one shard path")
        self.shards = [str(s) for s in shards]
        self.to_example = to_example
        self.verify_crc = verify_crc
        self._indexes = [tfrecord_index(p, cache=index_cache) for p in self.shards]
        counts = [len(ix) for ix in self._indexes]
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        self._len = int(self._starts[-1])

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int) -> Any:
        if idx < 0:
            idx += self._len
        if not 0 <= idx < self._len:
            raise IndexError(idx)
        shard = int(np.searchsorted(self._starts, idx, side="right")) - 1
        offset, length = self._indexes[shard][idx - int(self._starts[shard])]
        path = self.shards[shard]
        # open per call: thread-safe under the loader's worker threads, and
        # the OS page cache makes repeat opens ~free
        with open(path, "rb") as f:
            f.seek(int(offset))
            data = f.read(int(length))
            if self.verify_crc:
                footer = f.read(4)
                if len(data) < int(length) or len(footer) < 4:
                    raise ValueError(f"{path}: truncated record body @ {offset}")
                if _masked_crc(data) != struct.unpack("<I", footer)[0]:
                    raise ValueError(
                        f"{path}: corrupt record data @ {offset} (crc mismatch)"
                    )
        parsed = parse_tf_example(data)
        if self.to_example is not None:
            return self.to_example(parsed)
        parsed.setdefault(EXAMPLE_INDEX_KEY, idx)
        return Example(parsed)


def tfrecord_open_shard(
    path: str,
    to_example: Optional[Callable[[dict], Any]] = None,
    verify_crc: bool = True,
) -> Iterator[Any]:
    """Open one ``.tfrecord`` shard as an iterator of :class:`Example` —
    an ``open_shard`` for :class:`StreamingDataset`:

    .. code-block:: python

        StreamingDataset(
            shards=sorted(glob("data/train-*.tfrecord")),
            open_shard=functools.partial(
                tfrecord_open_shard, to_example=my_decode),
        )

    ``to_example`` maps the parsed feature dict (e.g. JPEG bytes +
    int64 labels) to an :class:`Example`; by default features pass through
    as-is.
    """
    for i, record in enumerate(read_tfrecord(path, verify_crc=verify_crc)):
        try:
            parsed = parse_tf_example(record)
        except ValueError as err:
            raise ValueError(
                f"{path}: record {i} is not a valid tf.train.Example ({err})"
            ) from None
        yield to_example(parsed) if to_example else Example(parsed)
