"""The port's data core on the CPU, held to the JAX package's host modules
item for item: ``Example`` and ``find_matching_indices``, the collator
(presence masks, nested ids, missing-id sentinels, strings), ``CombinedDataset``,
the samplers (single and distributed replicas, epochs) and ``DataLoader``
(sync against prefetch, ``pad_partial_batches``, an early break,
``iter_from_batch``). Host code: every output must be exactly equal, dtype
and key order included. Inputs are made from numpy seeds.
"""

import threading

import numpy as np
import pytest

from mmlearn_tpu.datasets.core.combined_dataset import CombinedDataset as JCombined
from mmlearn_tpu.datasets.core.data_collator import DefaultDataCollator as JCollator
from mmlearn_tpu.datasets.core.data_collator import collate_example_list as j_collate
from mmlearn_tpu.datasets.core.example import Example as JExample
from mmlearn_tpu.datasets.core.example import find_matching_indices as j_match
from mmlearn_tpu.datasets.core.loader import DataLoader as JLoader
from mmlearn_tpu.datasets.core.samplers import CombinedDatasetRatioSampler as JRatio
from mmlearn_tpu.datasets.core.samplers import DistributedEvalSampler as JEval
from mmlearn_tpu.datasets.core.samplers import RandomSampler as JRandom
from mmlearn_tpu_torch.constants import DATASET_INDEX_KEY, EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core import (
    CombinedDataset,
    CombinedDatasetRatioSampler,
    DataLoader,
    DefaultDataCollator,
    DistributedEvalSampler,
    Example,
    RandomSampler,
    SequentialSampler,
    collate_example_list,
    find_matching_indices,
)


def assert_same(got, want, path="batch", contiguous=True):
    """Equal structure, key order, types, dtypes, shapes and values; with
    ``contiguous`` (collated batches), the port's arrays C-contiguous."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]", contiguous)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.flags.c_contiguous or not contiguous, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]", contiguous)
    else:
        assert type(got) is type(want) and got == want, path


class Pairs:
    """A map-style dataset of ``example_cls`` items: an image, token ids,
    a caption and a label, with the text left out of every third example;
    it records the indices it fetched."""

    def __init__(self, example_cls, size=24, seed=0):
        rng = np.random.default_rng(seed)
        self.example_cls, self.size = example_cls, size
        self.images = rng.integers(0, 256, (size, 4, 4, 3), dtype=np.uint8)
        self.ids = rng.integers(1, 30, (size, 6)).astype(np.int32)
        self.fetched: list[int] = []
        self.lock = threading.Lock()

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        with self.lock:
            self.fetched.append(int(idx))
        ex = {"rgb": self.images[idx], "label": int(idx % 5), "caption": f"item {idx}",
              EXAMPLE_INDEX_KEY: int(idx)}
        if idx % 3:
            ex["text"] = self.ids[idx]
        return self.example_cls(ex)


class Stream:
    """An iterable dataset with no length: ``n`` items, then it ends."""

    def __init__(self, example_cls, n=5):
        self.example_cls, self.n = example_cls, n

    def __iter__(self):
        for i in range(self.n):
            yield self.example_cls({"rgb": np.full((4, 4, 3), i, np.uint8)})


def examples(example_cls, n=6, seed=1):
    """Hetero-keyed examples with nested ids (some missing), strings,
    opaque objects and python scalars."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ex = example_cls({"rgb": rng.standard_normal((3, 2)).astype(np.float32),
                          "score": float(i) / 3, "flag": bool(i % 2), "obj": (i, "x")})
        if i % 2:
            ex["text"] = rng.integers(0, 9, (5,)).astype(np.int64)
            ex["caption"] = f"caption {i}"
        ex["dataset_index"] = i % 2
        ex[EXAMPLE_INDEX_KEY] = i
        ex.create_ids()
        if i == 3:
            del ex["example_ids"]["rgb"]
        out.append(ex)
    return out


# ----------------------------------------------------------- Example, ids


def test_example_attribute_access_and_ids_match_jax():
    ex, jex = Example({"rgb": 1, "text": 2}), JExample({"rgb": 1, "text": 2})
    ex.dataset_index = jex.dataset_index = 3
    ex[EXAMPLE_INDEX_KEY] = jex[EXAMPLE_INDEX_KEY] = 7
    assert ex.rgb == 1 and DATASET_INDEX_KEY == "dataset_index"
    with pytest.raises(AttributeError):
        ex.missing
    with pytest.raises(ValueError, match="example_index"):
        Example({"rgb": 1}).create_ids()
    ex.create_ids()
    jex.create_ids()
    assert_same(dict(ex), dict(jex))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_matching_indices_matches_jax(seed):
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 4, (12, 2)).astype(np.int64)
    second = rng.integers(0, 4, (9, 2)).astype(np.int64)
    first[::5] = -1  # the collator's missing-id sentinel
    second[::4] = -1
    for got, want in zip(find_matching_indices(first, second), j_match(first, second)):
        assert_same(got, want)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        find_matching_indices(first[:, 0], second)


# -------------------------------------------------------------- collation


def test_collate_matches_jax():
    """Presence masks for the absent text and caption, the missing rgb id
    filled with (-1, -1), strings as lists, opaque objects as lists."""
    got = collate_example_list(examples(Example))
    want = j_collate(examples(JExample))
    assert_same(got, want)
    assert got["example_ids"]["rgb"][3].tolist() == [-1, -1]
    assert got["caption"] == ["", "caption 1", "", "caption 3", "", "caption 5"]
    assert got["text_presence"].tolist() == [False, True] * 3


def test_collate_rejects_ragged_and_empty_like_jax():
    for collate, ex_cls in ((collate_example_list, Example), (j_collate, JExample)):
        with pytest.raises(ValueError, match="Inconsistent shapes"):
            collate([ex_cls({"x": np.zeros(2)}), ex_cls({"x": np.zeros(3)})])
        with pytest.raises(ValueError, match="empty"):
            collate([])


def test_default_collator_batch_processors_match_jax():
    def tokenize(captions):
        return {"text": np.asarray([[len(c), 1] for c in captions], np.int32),
                "text_attention_mask": np.ones((len(captions), 2), np.int32)}

    procs = {"caption": tokenize, "score": lambda x: x * 2, "absent": lambda x: 1 / 0}
    got = DefaultDataCollator(procs)(examples(Example))
    want = JCollator(procs)(examples(JExample))
    assert_same(got, want)
    assert "caption" not in got


# ------------------------------------------------------- CombinedDataset


def test_combined_dataset_matches_jax_item_for_item():
    ds = CombinedDataset([Pairs(Example, 7, seed=0), Stream(Example), Pairs(Example, 5, seed=1)])
    jds = JCombined([Pairs(JExample, 7, seed=0), Stream(JExample), Pairs(JExample, 5, seed=1)])
    assert len(ds) == len(jds) == 13 and ds.cumulative_sizes == jds.cumulative_sizes
    assert ds.all_map_style is jds.all_map_style is False
    for i in [0, 6, 7, 7, 7, 8, -1, 12, 7, 7, 7, 7]:  # the stream restarts at its end
        assert_same(dict(ds[i]), dict(jds[i]))
    ds.set_epoch(1)
    jds.set_epoch(1)
    assert_same(dict(ds[7]), dict(jds[7]))
    with pytest.raises(IndexError):
        ds[13]
    nested = CombinedDataset([CombinedDataset([Pairs(Example, 3)]), Pairs(Example, 2)])
    assert nested.all_map_style and len(nested) == 5
    with pytest.raises(TypeError, match="Example"):
        CombinedDataset([[1, 2]])[0]


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_random_sampler_matches_jax(epoch):
    s, js = RandomSampler(range(37), seed=4), JRandom(range(37), seed=4)
    s.set_epoch(epoch)
    js.set_epoch(epoch)
    assert list(s) == list(js) and len(s) == 37
    assert list(SequentialSampler(range(5))) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("ratios,replacement,drop_last,num_samples", [
    (None, False, False, None),
    ([0.2, 0.5, 0.3], False, False, 40),
    ([1.0, 1.0, 6.0], True, True, 30),
    ([0.0, 1.0, 1.0], False, False, None),
])
@pytest.mark.parametrize("replicas", [1, 3])
def test_ratio_sampler_matches_jax(ratios, replacement, drop_last, num_samples, replicas):
    """Every rank of every epoch draws the JAX sampler's indices."""
    sizes = (7, 11, 5)
    ds = CombinedDataset([Pairs(Example, n) for n in sizes])
    jds = JCombined([Pairs(JExample, n) for n in sizes])
    for rank in range(replicas):
        kw = dict(ratios=ratios, replacement=replacement, drop_last=drop_last,
                  num_samples=num_samples, rank=rank, num_replicas=replicas, seed=3)
        s, js = CombinedDatasetRatioSampler(ds, **kw), JRatio(jds, **kw)
        for epoch in (0, 2):
            s.set_epoch(epoch)
            js.set_epoch(epoch)
            assert list(s) == list(js) and len(s) == len(js)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("replicas", [1, 4])
def test_distributed_eval_sampler_matches_jax(shuffle, replicas):
    for rank in range(replicas):
        s = DistributedEvalSampler(range(10), shuffle=shuffle, rank=rank, num_replicas=replicas)
        js = JEval(range(10), shuffle=shuffle, rank=rank, num_replicas=replicas)
        s.set_epoch(3)
        js.set_epoch(3)
        assert list(s) == list(js) and len(s) == len(js)


def test_rank_and_replicas_default_without_a_process_group():
    s = DistributedEvalSampler(range(6))
    assert (s.rank, s.num_replicas) == (0, 1)
    assert DistributedEvalSampler(range(6), rank=1, num_replicas=2).rank == 1
    with pytest.raises(TypeError, match="CombinedDataset"):
        CombinedDatasetRatioSampler(Pairs(Example, 3))


# ---------------------------------------------------------------- DataLoader


def _loaders(**kw):
    ds = CombinedDataset([Pairs(Example, 21)])
    jds = JCombined([Pairs(JExample, 21)])
    shuffle = kw.pop("shuffle", False)
    return (DataLoader(ds, shuffle=shuffle, seed=2, **kw),
            JLoader(jds, shuffle=shuffle, seed=2, **kw))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, prefetch_factor=1),
    dict(batch_size=4, num_workers=3),
    dict(batch_size=4, shuffle=True, drop_last=True),
    dict(batch_size=8, pad_partial_batches=True, num_workers=2),
], ids=["sync", "threads", "shuffled_drop_last", "padded"])
def test_loader_matches_jax(kw):
    loader, jloader = _loaders(**kw)
    assert len(loader) == len(jloader)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for a, b in zip(got, want):
            assert_same(a, b)
    if kw.get("pad_partial_batches"):
        assert got[-1]["batch_validity"].tolist() == [True] * 5 + [False] * 3


def test_sync_and_prefetch_loaders_agree():
    sync, _ = _loaders(batch_size=5, shuffle=True, prefetch_factor=1)
    pre, _ = _loaders(batch_size=5, shuffle=True, num_workers=2, prefetch_factor=3)
    for a, b in zip(list(sync), list(pre), strict=True):
        assert_same(a, b)


def test_early_break_releases_the_prefetch_thread():
    """A consumer that stops after two batches: the prefetch thread ends
    (the pool's two threads stay for the next pass) and fetches no more."""
    import time

    loader, _ = _loaders(batch_size=2, num_workers=2)
    before = threading.active_count()
    it = iter(loader)
    next(it), next(it)
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before + 2
    fetched = len(loader.dataset.datasets[0].fetched)
    time.sleep(0.2)
    assert len(loader.dataset.datasets[0].fetched) == fetched < 21
    assert len(list(loader)) == len(loader)  # a fresh pass starts over


def test_close_waits_for_the_prefetch_thread_and_no_fetch_follows():
    """A fetch in flight when the consumer closes: ``close`` returns only
    once the prefetch thread has ended, and no example is fetched after."""
    import time

    class Slow(Pairs):
        def __getitem__(self, idx):
            time.sleep(0.05)
            return super().__getitem__(idx)

    loader = DataLoader(CombinedDataset([Slow(Example, 21)]), batch_size=2, num_workers=2,
                        prefetch_factor=1)
    it = iter(loader)
    next(it)
    time.sleep(0.02)  # the next batch's fetch has begun
    it.close()
    assert not any(t.name == "DataLoader prefetch" for t in threading.enumerate())
    fetched = len(loader.dataset.datasets[0].fetched)
    time.sleep(0.3)
    assert len(loader.dataset.datasets[0].fetched) == fetched < 21


@pytest.mark.parametrize("prefetch_factor", [1, 3])
def test_iter_from_batch_skips_fetches_and_keeps_the_order(prefetch_factor):
    """The batches from 3 on equal an uninterrupted epoch's (and the JAX
    loader's), and no example of the 3 skipped batches is fetched."""
    loader, jloader = _loaders(batch_size=3, shuffle=True, prefetch_factor=prefetch_factor)
    loader.set_epoch(1)
    jloader.set_epoch(1)
    full = list(loader)
    inner = loader.dataset.datasets[0]
    inner.fetched.clear()
    got = list(loader.iter_from_batch(3))
    want = list(jloader.iter_from_batch(3))
    assert len(got) == len(full) - 3
    for a, b, c in zip(got, want, full[3:]):
        assert_same(a, b)
        assert_same(a, c)
    skipped = {int(i) for b in full[:3] for i in b[EXAMPLE_INDEX_KEY]}
    assert not skipped & set(inner.fetched) and len(inner.fetched) == 21 - 9
    assert loader.iter_from_batch(0) is not None


def test_iter_from_batch_declines_streams():
    ds = CombinedDataset([Pairs(Example, 4), Stream(Example)])
    assert DataLoader(ds, batch_size=2).iter_from_batch(1) is None
    assert DataLoader(Pairs(Example, 4), batch_size=2).iter_from_batch(1) is None


def test_producer_error_reaches_the_consumer():
    class Broken(Pairs):
        def __getitem__(self, idx):
            if idx == 5:
                raise RuntimeError("decode failed")
            return super().__getitem__(idx)

    loader = DataLoader(CombinedDataset([Broken(Example, 8)]), batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(loader)
