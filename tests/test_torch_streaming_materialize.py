"""The port's ``StreamingDataset`` and corpus materialization against the
JAX package's, on the CPU: the same stream, example for example, for the
same seed, rank, world size and epoch (shard order, assignment, the
shuffle buffer, ``infinite``); the port's default rank and world size
without a process group; ``materialize``'s shard files byte for byte (map
style, a one-shot iterator, a shard factory, split over ranks) and
``MaterializedDataset`` item for item. Held bit for bit.
"""

import functools
import importlib
import os
import pathlib

import numpy as np
import pytest

from mmlearn_tpu.datasets.core import streaming as jstream
from mmlearn_tpu.datasets.core.example import Example as JExample
from mmlearn_tpu_torch.datasets.core import streaming
from mmlearn_tpu_torch.datasets.core import tfrecord as tf
from mmlearn_tpu_torch.datasets.core.example import Example
from tests.test_torch_tfrecord import same

# the modules (each package exports a function of the same name)
mat = importlib.import_module("mmlearn_tpu_torch.datasets.materialize")
jmat = importlib.import_module("mmlearn_tpu.datasets.materialize")
SHARDS = [f"s{i}" for i in range(7)]


def open_shard(name, example_cls):
    base = int(name[1:]) * 100
    for i in range(5 + int(name[1:]) % 3):
        yield example_cls({"v": base + i})


def stream(module, example_cls, epochs=2, **kw):
    ds = module.StreamingDataset(SHARDS, functools.partial(open_shard, example_cls=example_cls),
                                 **kw)
    out = []
    for e in range(epochs):
        ds.set_epoch(e)
        out.append([ex["v"] for ex in ds])
    return out


@pytest.mark.parametrize("rank,world,buffer,shuffle", [
    (0, 1, 0, True), (1, 3, 0, True), (2, 3, 4, True), (0, 2, 64, True), (3, 4, 3, False),
])
def test_stream_equals_the_jax_stream(rank, world, buffer, shuffle):
    kw = dict(rank=rank, world_size=world, shuffle_buffer=buffer, shuffle_shards=shuffle, seed=5)
    got = stream(streaming, Example, **kw)
    assert got == stream(jstream, JExample, **kw)
    if shuffle:
        assert got[0] != got[1]  # the epochs come in different orders


def test_ranks_disjoint_and_covering():
    seen = [stream(streaming, Example, epochs=1, rank=r, world_size=3, seed=2)[0]
            for r in range(3)]
    flat = [v for s in seen for v in s]
    assert len(flat) == len(set(flat))
    assert set(flat) == {ex["v"] for s in SHARDS for ex in open_shard(s, dict)}


def test_default_rank_and_world_without_a_process_group():
    ds = streaming.StreamingDataset(SHARDS, functools.partial(open_shard, example_cls=Example))
    assert (ds.rank, ds.world_size) == (0, 1)
    assert stream(streaming, Example, seed=1) == stream(jstream, JExample, seed=1, rank=0,
                                                         world_size=1)


def test_infinite_length_and_errors():
    def take(module, example_cls):
        ds = module.StreamingDataset(SHARDS, functools.partial(open_shard,
                                                               example_cls=example_cls),
                                     rank=1, world_size=2, seed=3, infinite=True)
        it = iter(ds)
        return [next(it)["v"] for _ in range(60)]

    assert take(streaming, Example) == take(jstream, JExample)
    with pytest.raises(TypeError, match="length"):
        len(streaming.StreamingDataset(SHARDS, iter, rank=0, world_size=1))
    assert len(streaming.StreamingDataset(SHARDS, iter, rank=0, world_size=1, length=9)) == 9
    with pytest.raises(ValueError, match="cannot cover"):
        streaming.StreamingDataset(SHARDS[:2], iter, rank=0, world_size=3)


def test_jsonl_shards(tmp_path):
    path = tmp_path / "a.jsonl"
    path.write_text('{"x": 1, "t": "a"}\n\n{"x": 2, "t": "b"}\n')
    got = [dict(e) for e in streaming.jsonl_open_shard(str(path))]
    assert got == [dict(e) for e in jstream.jsonl_open_shard(str(path))]
    assert got == [{"x": 1, "t": "a"}, {"x": 2, "t": "b"}]


def sample(i):
    rng = np.random.default_rng(i)
    return {"rgb": rng.integers(0, 256, (4, 5, 3), dtype=np.uint8),
            "emb": rng.standard_normal(3).astype(np.float32),
            "ids": np.arange(i, i + 4, dtype=np.int32), "label": i, "name": f"n{i}",
            "raw": bytes([i]) * 3}


class Samples:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return sample(i)


def files(result):
    return {os.path.basename(p): pathlib.Path(p).read_bytes() for p in result.shards}


def test_packed_bytes_equal():
    s = sample(3)
    assert mat.encode_packed(s) == jmat.encode_packed(s)
    got = mat.decode_packed(tf.parse_tf_example(mat.encode_packed(s)))
    same(got, jmat.decode_packed(tf.parse_tf_example(mat.encode_packed(s))))
    want = {**s, "name": s["name"].encode()}  # a str leaf comes back as bytes
    same(dict(sorted(got.items())), dict(sorted(want.items())))
    with pytest.raises(ValueError, match="collides"):
        mat.encode_packed({"a/shape": 1})
    with pytest.raises(TypeError, match="object"):
        mat.encode_packed({"a": np.asarray([object()])})


@pytest.mark.parametrize("source", ["map", "iterator", "factory"])
def test_materialize_shards_byte_equal(tmp_path, source):
    """Each source form, split over 2 ranks: the same shard files, byte for
    byte, as the JAX package's; together the ranks cover every sample."""
    out = {}
    for name, module in (("port", mat), ("jax", jmat)):
        out[name] = {}
        for rank in range(2):
            kw = dict(output_dir=str(tmp_path / name), shard_size=3, rank=rank, world_size=2)
            if source == "map":
                result = module.materialize(Samples(), **kw)
            elif source == "iterator":
                result = module.materialize((sample(i) for i in range(11)), **kw)
            else:
                result = module.materialize(
                    samples_for_shard=lambda s, a, b: (sample(i) for i in range(a, b)),
                    num_samples=11, **kw)
            assert result.num_samples == 11
            out[name].update(files(result))
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == [f"train-{i:05d}.tfrecord" for i in range(4)]
    shards = sorted(str(tmp_path / "port" / f) for f in out["port"])
    ds, jds = mat.MaterializedDataset(shards, verify_crc=True), jmat.MaterializedDataset(shards)
    assert len(ds) == len(jds) == 11
    for i in range(11):
        got = ds[i]
        assert isinstance(got, Example)
        same(dict(got), dict(jds[i]))
        np.testing.assert_array_equal(got["rgb"], sample(i)["rgb"])


def test_materialize_empty_source(tmp_path):
    assert mat.materialize([], str(tmp_path)).shards == []
    with pytest.raises(ValueError, match="num_samples"):
        mat.materialize(output_dir=str(tmp_path), samples_for_shard=lambda *a: [])
