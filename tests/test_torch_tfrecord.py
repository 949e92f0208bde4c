"""The port's TFRecord codec against the JAX package's, on the CPU: the
CRC-32C (native and Python) on the JAX test's vectors, ``tf.train.Example``
bytes, records and index caches written by one package and read by the
other, ``TFRecordDataset`` and ``tfrecord_open_shard`` item for item, and
the same errors on corrupt and malformed input. Everything is held bit for
bit: both sides compute the same bytes.
"""

import os
import pathlib

import numpy as np
import pytest

from mmlearn_tpu.datasets.core import tfrecord as jtf
from mmlearn_tpu_torch import native
from mmlearn_tpu_torch.datasets.core import tfrecord as tf
from mmlearn_tpu_torch.datasets.core.example import Example

FEATURES = [
    {"a": b"x"},
    {"image": b"\xff\xd8jpegbytes", "caption": ["a dog", "ein Hund"],
     "label": np.asarray([3, -7, 2**40], np.int64), "score": np.asarray([0.5, -1.25], np.float32),
     "flag": True, "scalar": 4.5},
    {"tags": [], "ids": np.asarray([], np.int64), "scores": np.asarray([], np.float32)},
    {"u8": np.arange(7, dtype=np.uint8), "neg": -1, "big": np.asarray([2**62, -(2**62)])},
]


def same(got, want) -> None:
    """``got`` equals ``want`` key for key and bit for bit (Examples, dicts,
    lists, arrays with their dtypes, bytes and numbers)."""
    assert type(got).__name__ == type(want).__name__, (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def records(n=6):
    rng = np.random.default_rng(3)
    return [tf.encode_tf_example({"idx": np.asarray([i]),
                                  "payload": rng.integers(0, 256, 37 * i, dtype=np.uint8).tobytes(),
                                  "name": f"ex{i}"})
            for i in range(n)]


def test_crc32c_on_the_jax_vectors():
    """The JAX test's vectors, every size around the 8-byte stride, and a
    continued CRC: native, the port's Python table, the JAX package's
    Python table and its native library agree."""
    assert tf.crc32c(b"123456789") == native.crc32c(b"123456789") == 0xE3069283
    assert tf.crc32c(b"") == 0 and tf.crc32c(b"\x00" * 32) == 0x8A9136AA
    rng = np.random.default_rng(42)
    for size in (0, 1, 7, 8, 9, 63, 64, 1024, 4097):
        data = rng.integers(0, 256, size).astype(np.uint8).tobytes()
        want = jtf._crc32c_py(data)
        assert native.crc32c(data) == tf._crc32c_py(data) == jtf.crc32c(data) == want, size
    data = rng.integers(0, 256, 333).astype(np.uint8).tobytes()
    assert native.crc32c(data[200:], native.crc32c(data[:200])) == jtf._crc32c_py(data)


def test_python_crc_switch(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "crc32c", lambda *a: calls.append(a))
    monkeypatch.setenv("MMLEARN_TFRECORD_PYCRC", "1")
    assert tf.crc32c(b"123456789") == 0xE3069283 and not calls
    monkeypatch.setenv("MMLEARN_TFRECORD_PYCRC", "0")
    tf.crc32c(b"abc")
    assert calls == [(b"abc", 0)]


@pytest.mark.parametrize("case", range(len(FEATURES)))
def test_example_bytes_equal(case):
    data = tf.encode_tf_example(FEATURES[case])
    assert data == jtf.encode_tf_example(FEATURES[case])
    same(tf.parse_tf_example(data), jtf.parse_tf_example(data))
    if case == 0:  # the JAX test's hand-computed wire bytes
        assert data == bytes.fromhex("0a0c0a0a0a01611205" "0a030a0178")


def test_errors_equal():
    for bad in (b"\x0a\xff", b"\x0a\x7fonly-a-few-bytes"):
        with pytest.raises(ValueError) as got:
            tf.parse_tf_example(bad)
        with pytest.raises(ValueError) as want:
            jtf.parse_tf_example(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="flat"):
        tf.encode_tf_example({"x": np.zeros((2, 2))})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_read_by_the_other_package(tmp_path, writer):
    """A shard written by one package: the same file bytes from both
    writers, read back equal by both readers with CRCs checked."""
    recs = records()
    paths = {}
    for name, mod in (("port", tf), ("jax", jtf)):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        assert mod.write_tfrecord(paths[name], iter(recs)) == len(recs)
    assert pathlib.Path(paths["port"]).read_bytes() == pathlib.Path(paths["jax"]).read_bytes()
    assert list(tf.read_tfrecord(paths[writer])) == recs
    assert list(jtf.read_tfrecord(paths[writer])) == recs
    for got, want in zip(tf.tfrecord_open_shard(paths[writer]),
                         jtf.tfrecord_open_shard(paths[writer])):
        assert isinstance(got, Example)
        same(dict(got), dict(want))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_cache_read_across_packages(tmp_path, writer):
    """The ``<shard>.idx.npz`` cache one package writes is read, not
    rebuilt, by the other; a rewritten shard's cache is ignored."""
    path = str(tmp_path / "s.tfrecord")
    tf.write_tfrecord(path, iter(records()))
    first, second = (tf, jtf) if writer == "port" else (jtf, tf)
    index = first.tfrecord_index(path)
    cache = path + ".idx.npz"
    stamp = os.stat(cache).st_mtime_ns
    np.testing.assert_array_equal(second.tfrecord_index(path), index)
    assert os.stat(cache).st_mtime_ns == stamp
    with np.load(cache) as z:  # the JAX package's keys
        assert sorted(z.files) == ["index", "mtime", "size"]
    tf.write_tfrecord(path, iter(records(2)))
    os.utime(path, ns=(stamp + 10**9, stamp + 10**9))
    assert len(second.tfrecord_index(path)) == len(first.tfrecord_index(path)) == 2


def test_dataset_item_for_item(tmp_path):
    """``TFRecordDataset`` over two shards, in any order, equal to the JAX
    one's; both detect a corrupt record and give the same error."""
    shards = []
    for s, n in enumerate((4, 3)):
        shards.append(str(tmp_path / f"shard-{s}.tfrecord"))
        tf.write_tfrecord(shards[-1], iter(records(n)[s:]))
    ds, jds = tf.TFRecordDataset(shards, verify_crc=True), jtf.TFRecordDataset(shards,
                                                                               verify_crc=True)
    assert len(ds) == len(jds) == 6
    for idx in (5, 0, 4, 3, 2, 1, -1):
        same(dict(ds[idx]), dict(jds[idx]))
    with pytest.raises(IndexError):
        ds[6]
    raw = bytearray(pathlib.Path(shards[1]).read_bytes())
    raw[-6] ^= 0xFF
    pathlib.Path(shards[1]).write_bytes(bytes(raw))
    errors = []
    for mod in (tf, jtf):
        with pytest.raises(ValueError, match="corrupt record data") as err:
            mod.TFRecordDataset(shards, verify_crc=True, index_cache=False)[5]
        errors.append(str(err.value))
    assert errors[0] == errors[1]
