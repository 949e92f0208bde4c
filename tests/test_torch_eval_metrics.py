"""The port's evaluation metrics against the JAX package's, on the CPU.

The classification functions are a copy of the JAX package's numpy code and
must agree to 1e-12. ``RetrievalRecallAtK`` must give the same recall as the
JAX metric exactly: recall counts rows whose positive is among the top k, and
every case here keeps the k-th and (k+1)-th scores apart, or ties them on
purpose, where both sides must break the tie toward the lower target row
(``jax.lax.top_k``'s order).
"""

import numpy as np
import pytest
import torch

from mmlearn_tpu.modules.metrics import classification as jcls
from mmlearn_tpu.modules.metrics import retrieval_recall as jrr
from mmlearn_tpu_torch.modules.metrics import classification as cls
from mmlearn_tpu_torch.modules.metrics import retrieval_recall as rr


def _scores_and_targets(seed: int, n: int = 60, c: int = 5, ties: bool = False,
                        absent: bool = False):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((n, c))
    if ties:
        scores = np.round(scores, 1)  # many equal scores in every column
    targets = rng.integers(0, c - 1 if absent else c, n)  # class c-1 absent
    return scores, targets


CLASSIFICATION_CASES = [
    ("top_k_accuracy", dict(k=1)), ("top_k_accuracy", dict(k=2)),
    ("top_k_accuracy", dict(k=3)),
    ("macro_precision", {}), ("macro_recall", {}), ("macro_f1", {}),
    ("binary_precision", {}), ("binary_recall", {}), ("binary_f1", {}),
    ("_binary_auroc", {}), ("macro_auroc", {}),
]


@pytest.mark.parametrize("ties,absent", [(False, False), (True, False), (True, True)],
                         ids=["plain", "tied", "tied-absent-class"])
@pytest.mark.parametrize("name,kw", CLASSIFICATION_CASES,
                         ids=[f"{n}{kw.get('k', '')}" for n, kw in CLASSIFICATION_CASES])
def test_classification_metric_matches_jax(name, kw, ties, absent):
    scores, targets = _scores_and_targets(3, ties=ties, absent=absent)
    c = scores.shape[1]
    preds = scores.argmax(axis=1)
    if name == "top_k_accuracy":
        args = (scores, targets, kw["k"])
    elif name.startswith("macro_auroc"):
        args = (scores, targets, c)
    elif name.startswith("macro_"):
        args = (preds, targets, c)
    elif name == "_binary_auroc":
        args = (scores[:, 0], targets == 0)
    else:
        args = ((scores[:, 0] > 0).astype(np.int64), (targets == 0).astype(np.int64))
    got, want = getattr(cls, name)(*args), getattr(jcls, name)(*args)
    assert want is not None and np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_auroc_of_a_single_class_is_none():
    """One class present: no AUROC (``None``), as the JAX function; a class
    absent from the targets drops out of the macro average."""
    scores = np.linspace(0, 1, 10)
    assert cls._binary_auroc(scores, np.ones(10, bool)) is None
    assert jcls._binary_auroc(scores, np.ones(10, bool)) is None
    assert cls._binary_auroc(scores, np.zeros(10, bool)) is None
    s, t = _scores_and_targets(5, absent=True)
    assert cls.macro_auroc(s, t, s.shape[1]) == jcls.macro_auroc(s, t, s.shape[1])


# ------------------------------------------------------------------ recall


def _recall(module, batches, ks, **kw):
    metric = module.RetrievalRecallAtK(top_k=max(ks), **kw)
    for b in batches:
        metric.update(*b)
    return metric.compute_many(ks)


def _noisy_pairs(seed: int, n: int, d: int = 8, noise: float = 0.3):
    rng = np.random.default_rng(seed)
    targets = rng.standard_normal((n, d)).astype(np.float32)
    queries = targets + noise * rng.standard_normal((n, d)).astype(np.float32)
    return queries, targets


def _recall_case(case: str):
    """``(batches, ks)``: each batch ``(queries, targets, indexes, valid)``."""
    q, t = _noisy_pairs(1, 50)
    if case == "two-updates":  # auto offsets across updates
        return [(q[:20], t[:20], None, None), (q[20:], t[20:], None, None)], [1, 5]
    if case == "validity":  # padded rows dropped
        valid = np.arange(50) % 7 != 3
        return [(q, t, None, valid)], [1, 3, 5]
    if case == "mid-batch-invalid":  # the offset counts stored rows only
        v1 = np.array([False] + [True] * 24)
        v2 = np.array([True, False] * 12 + [True])
        return [(q[:25], t[:25], None, v1), (q[25:], t[25:], None, v2)], [1, 2]
    if case == "explicit-indexes":  # given positives, filtered by valid
        perm = np.random.default_rng(2).permutation(50)
        valid = np.ones(50, bool)
        valid[[4, 9]] = False
        return [(q[perm], t, perm, None), (q[:10], t[:10], np.arange(50, 60), valid[:10])], [1, 4]
    if case == "duplicates":  # identical rows tie; the lower row wins
        t_dup = np.repeat(t[:10], 5, axis=0)
        q_dup = np.repeat(q[:10], 5, axis=0)
        return [(q_dup[:30], t_dup[:30], None, None), (q_dup[30:], t_dup[30:], None, None)], [1, 3, 5, 7]
    raise ValueError(case)


RECALL_CASES = ["two-updates", "validity", "mid-batch-invalid", "explicit-indexes", "duplicates"]


@pytest.mark.parametrize("route", ["full-axis", "blockwise", "key-slices"])
@pytest.mark.parametrize("case", RECALL_CASES)
def test_recall_matches_jax_exactly(case, route, monkeypatch):
    batches, ks = _recall_case(case)
    if route == "blockwise":  # every similarity "too big": 7-row target blocks on both sides
        for module in (jrr, rr):
            monkeypatch.setattr(module, "TOPK_SIM_BYTES_BUDGET", 0)
            monkeypatch.setattr(module, "TOPK_BLOCK", 7)
    if route == "key-slices":  # the port's order keys built one query row at a time
        monkeypatch.setattr(rr, "TOPK_KEY_ELEMENTS", 7)
    got = _recall(rr, batches, ks)
    want = _recall(jrr, batches, ks)
    assert got == want, (got, want)
    if case == "duplicates":
        # five copies of each target: the first copy ranks first, so only a
        # query whose positive is that copy is a hit at k=1
        assert want[1] < 0.5 and want[5] == 1.0


def test_recall_with_masks_as_tensors_and_separate_computes():
    """Masks given as tensors (the trainer passes device masks) give the
    numpy masks' recall; ``compute_many`` equals one ``compute`` a k."""
    batches, ks = _recall_case("mid-batch-invalid")
    as_tensors = [(torch.from_numpy(q), torch.from_numpy(t), i, torch.from_numpy(v))
                  for q, t, i, v in batches]
    many = _recall(rr, as_tensors, ks)
    assert many == _recall(rr, batches, ks)
    for k in ks:
        assert _recall(rr, batches, [k]) == {k: many[k]}
        metric = rr.RetrievalRecallAtK(top_k=k)
        for b in batches:
            metric.update(*b)
        assert metric.compute() == many[k]


def test_topk_breaks_ties_toward_the_lower_row():
    """Equal scores: the lower target row first, as ``jax.lax.top_k``, in
    the selection itself (where -0.0 ranks below +0.0, JAX's total order,
    and negative scores keep their order) and through the full-axis and
    blockwise routes and their merge."""
    import jax

    scores = np.array([[0.5, 1.0, 0.5, 1.0, -0.0, 0.0, -2.0, -1.0, 1.0, 0.5, -1.0]],
                      np.float32)
    n = scores.shape[1]
    want = np.asarray(jax.lax.top_k(scores, n)[1])[0].tolist()
    assert want == [1, 3, 8, 0, 2, 9, 5, 4, 7, 10, 6]
    s, rows = rr._topk_by_key(torch.from_numpy(scores), torch.arange(n)[None], n, n)
    assert rows[0].tolist() == want
    np.testing.assert_array_equal(s.numpy()[0], scores[0, want])
    # through the product (a sum from +0.0 has no -0.0): the similarity of
    # the query [1] is the target column itself
    scores[0, 4] = 0.25
    want = np.asarray(jax.lax.top_k(scores, n)[1])[0].tolist()
    queries, targets = torch.ones(1, 1), torch.from_numpy(scores.T.copy())
    assert rr._topk_scores_chunk(queries, targets, n)[1][0].tolist() == want
    for block in (1, 2, 3, 4):
        for k in range(1, block + 1):
            _, blocked = rr._blockwise_topk_scores_chunk(queries, targets, k, block)
            assert blocked[0].tolist() == want[:k], (block, k)


@pytest.mark.parametrize("key_elements", [1, 64, 1 << 25])
def test_topk_matches_a_stable_sort_under_many_ties(key_elements, monkeypatch):
    """Integer scores tie everywhere: the full-axis and blockwise top-k
    equal a stable descending sort (the lower row first) at every k,
    whether the order keys are built one row at a time or all at once."""
    monkeypatch.setattr(rr, "TOPK_KEY_ELEMENTS", key_elements)
    gen = torch.Generator().manual_seed(3)
    queries = torch.randint(-2, 3, (24, 6), generator=gen).float()
    targets = torch.randint(-2, 3, (40, 6), generator=gen).float()
    stable = torch.sort(queries @ targets.T, dim=1, descending=True, stable=True).indices
    for k in (1, 3, 7, 40):
        assert torch.equal(rr._topk_scores_chunk(queries, targets, k)[1], stable[:, :k]), k
        if k <= 7:
            got = rr._blockwise_topk_scores_chunk(queries, targets, k, 7)[1]
            assert torch.equal(got, stable[:, :k]), k


def test_merge_gathered_shards_matches_jax():
    counts = np.array([[2, 3], [1, 2], [3, 1]])
    rng = np.random.default_rng(0)
    gq = rng.standard_normal((3, 3, 4))
    gt = rng.standard_normal((3, 3, 4))
    gi = rng.integers(0, 3, (3, 3))
    for got, want in zip(rr._merge_gathered_shards(gq, gt, gi, counts),
                         jrr._merge_gathered_shards(gq, gt, gi, counts)):
        np.testing.assert_array_equal(got, want)
    assert rr._merge_gathered_shards(gq, gt, gi, counts)[2].tolist() == (
        [gi[0, 0], gi[0, 1], gi[1, 0] + 3, gi[2, 0] + 5, gi[2, 1] + 5, gi[2, 2] + 5])
