"""Recall@K and its exact inner-product top-k, counterpart of
:mod:`mmlearn_tpu.modules.metrics.retrieval_recall` (``_topk_scores_chunk``
:31, ``_blockwise_topk_scores_chunk`` :51, ``_use_blockwise_topk`` :102,
``_topk_chunk`` :112, ``_merge_gathered_shards`` :120,
``RetrievalRecallAtK`` :142).

Similarities are full f32 products: TF32 keeps about three decimal digits,
which cannot separate a self-similarity of 1.0 from a 0.9995-similar
neighbour, so :func:`full_f32_matmul` turns it off around every product
(the JAX package's ``Precision.HIGHEST``).

Ties: ``jax.lax.top_k`` puts the lower index first among equal scores;
``torch.topk`` promises no order, and its CPU and CUDA orders differ. Every
top-k here follows one int64 key a score, :func:`_order_key`: the
score's bits in an order-preserving integer above the complement of the
target row, so the keys are distinct and the lower row wins a tie, on every
device, in the per-block selections and in their merge alike. Duplicate
images or prompts embed identically, and recall then depends on this rule.
The keys are built only where they can change the answer: ``torch.topk``
selects on the f32 scores, rows whose k-th score equals their (k+1)-th
select again on the keys (a slice of rows at a time,
:data:`TOPK_KEY_ELEMENTS`, so the keys' transient memory stays a constant
beside the f32 matrix that :data:`TOPK_SIM_BYTES_BUDGET` bounds), and the k
selected are sorted on theirs.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize

#: target-block length of the streaming exact top-k (the JAX package's)
TOPK_BLOCK = 131072

#: f32 similarity-matrix bytes above which exact top-k streams over target
#: blocks instead of materialising the whole (queries, targets) matrix
TOPK_SIM_BYTES_BUDGET = 4 << 30

#: scores whose order keys are built at once: about 16 bytes each while a
#: slice's keys are made (the int32 map, then the int64 key), 512 MiB
TOPK_KEY_ELEMENTS = 1 << 25


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """Run float32 matmuls in full f32 (no TF32), restoring the setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _order_key(scores: torch.Tensor, rows: torch.Tensor, num_targets: int) -> torch.Tensor:
    """int64 keys ordered as (score descending, row ascending): the f32
    score's bits mapped to an int32 of the same order (negative floats have
    their magnitude bits flipped, so -0.0 sorts below +0.0, as in
    ``jax.lax.top_k``'s total order) in the high word, and ``num_targets - 1
    - row`` in the low word. ``rows`` broadcasts against ``scores``."""
    bits = scores.float().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return key.mul_(1 << 32).sub_(rows).add_(num_targets - 1)


def _key_topk(
    scores: torch.Tensor, rows: torch.Tensor, which: torch.Tensor, k: int, num_targets: int
):
    """Column positions of the ``k`` best of the rows ``which`` of
    ``scores`` under :func:`_order_key`, best first; the keys (and the
    target rows they read) of at most :data:`TOPK_KEY_ELEMENTS` scores
    exist at once."""
    step = max(1, TOPK_KEY_ELEMENTS // max(1, scores.shape[1]))
    picks = []
    for i in range(0, which.shape[0], step):
        part = which[i : i + step]
        picks.append(torch.topk(_order_key(scores[part], rows[part], num_targets), k,
                                dim=1).indices)
    return torch.cat(picks)


def _topk_by_key(scores: torch.Tensor, rows: torch.Tensor, k: int, num_targets: int):
    """``(scores, rows)`` of the ``k`` best columns of each row of
    ``scores`` under :func:`_order_key`, best first.

    The f32 ``torch.topk`` selects ``k + 1``: where the k-th score is above
    the (k+1)-th, every score equal to the k-th is among the first ``k``,
    so its tie order cannot change the set. The rows where the two are
    equal (found with one host sync) select again on the keys. The ``k``
    selected are then put in key order."""
    rows = rows.expand_as(scores)
    take = min(k + 1, scores.shape[1])
    top, pick = torch.topk(scores, take, dim=1)
    pick = pick[:, :k]
    if take > k:
        split = top[:, k - 1] == top[:, k]
        if bool(split.any()):
            redo = split.nonzero().squeeze(1)
            pick[redo] = _key_topk(scores, rows, redo, k, num_targets)
    picked_rows = torch.gather(rows, 1, pick)
    order = torch.sort(_order_key(torch.gather(scores, 1, pick), picked_rows, num_targets),
                       dim=1, descending=True).indices
    pick = torch.gather(pick, 1, order)
    return torch.gather(scores, 1, pick), torch.gather(picked_rows, 1, order)


def _topk_scores_chunk(queries: torch.Tensor, targets: torch.Tensor, k: int):
    """Top-k (scores, target rows) of one query chunk over every target,
    the lower row first among equal scores."""
    with full_f32_matmul():
        sim = queries @ targets.T
    n = targets.shape[0]
    rows = torch.arange(n, device=sim.device)[None]
    return _topk_by_key(sim, rows, k, n)


def _blockwise_topk_scores_chunk(
    queries: torch.Tensor, targets: torch.Tensor, k: int, block: int
):
    """Exact top-k streamed over target blocks: per-block top-k, then one
    merge over the survivors, all under the same order as
    :func:`_topk_scores_chunk`. The (queries, targets) similarity never
    exists whole; (queries, block) is the peak."""
    n = targets.shape[0]
    scores, rows = [], []
    for start in range(0, n, block):
        with full_f32_matmul():
            sim = queries @ targets[start : start + block].T
        cols = torch.arange(start, start + sim.shape[1], device=sim.device)[None]
        s, i = _topk_by_key(sim, cols, min(k, sim.shape[1]), n)
        scores.append(s)
        rows.append(i)
    return _topk_by_key(torch.cat(scores, dim=1), torch.cat(rows, dim=1), k, n)


def _use_blockwise_topk(num_queries: int, num_targets: int, k: int) -> bool:
    """Blockwise only when the full f32 similarity would exceed the budget
    (and a per-block top-k is well formed, k <= block)."""
    return (
        num_queries * num_targets * 4 > TOPK_SIM_BYTES_BUDGET
        and num_targets > TOPK_BLOCK >= k
    )


def _topk_chunk(queries: torch.Tensor, targets: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k target rows only; streams over target blocks when the whole
    similarity matrix would exceed :data:`TOPK_SIM_BYTES_BUDGET`."""
    if _use_blockwise_topk(queries.shape[0], targets.shape[0], k):
        return _blockwise_topk_scores_chunk(queries, targets, k, TOPK_BLOCK)[1]
    return _topk_scores_chunk(queries, targets, k)[1]


def _merge_gathered_shards(
    gq: np.ndarray, gt: np.ndarray, gi: np.ndarray, counts: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-process padded shards into global (queries, targets, indexes).

    ``gq``: (P, max_q, D), ``gt``: (P, max_t, D), ``gi``: (P, max_q),
    ``counts``: (P, 2) of per-process (num_queries, num_targets). Positive
    indexes are local to each process's targets and are offset by the
    target counts of the processes before it.
    """
    offsets = np.concatenate([[0], np.cumsum(counts[:, 1])[:-1]])
    qs, ts, idxs = [], [], []
    for p in range(len(counts)):
        nq, nt = int(counts[p, 0]), int(counts[p, 1])
        qs.append(gq[p, :nq])
        ts.append(gt[p, :nt])
        idxs.append(gi[p, :nq] + offsets[p])
    return np.concatenate(qs), np.concatenate(ts), np.concatenate(idxs)


def _gather_processes(queries: torch.Tensor, targets: torch.Tensor, indexes: np.ndarray):
    """Every process's rows (the batch's shards over ``data x fsdp``, of
    unequal sizes under an unpadded eval sampler), merged in rank order with
    the positives offset as :func:`_merge_gathered_shards` does; one process
    keeps its own."""
    from mmlearn_tpu_torch.parallel.collectives import axis_size, process_allgather_object

    if axis_size() == 1:
        return queries, targets, indexes
    parts = process_allgather_object(
        (queries.cpu().numpy(), targets.cpu().numpy(), np.asarray(indexes)))
    counts = np.array([[len(q), len(t)] for q, t, _ in parts], np.int64)
    max_q, max_t = int(counts[:, 0].max()), int(counts[:, 1].max())
    gq = np.zeros((len(parts), max_q, queries.shape[-1]), parts[0][0].dtype)
    gt = np.zeros((len(parts), max_t, targets.shape[-1]), parts[0][1].dtype)
    gi = np.zeros((len(parts), max_q), np.int64)
    for p, (q, t, i) in enumerate(parts):
        gq[p, :len(q)], gt[p, :len(t)], gi[p, :len(i)] = q, t, i
    q, t, i = _merge_gathered_shards(gq, gt, gi, counts)
    return (torch.from_numpy(q).to(queries.device), torch.from_numpy(t).to(targets.device), i)


def _rows(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@store(group="modules/metrics", name="RetrievalRecallAtK", populate_full_signature=False)
class RetrievalRecallAtK:
    """Recall@K over accumulated (query, target, positive-index) triples.

    :meth:`update` keeps each batch as it is given (tensors stay where they
    live, on the card in evaluation) with its validity mask, and launches
    nothing: no host sync a batch. :meth:`compute_many` moves every mask to
    the host in one transfer, selects the valid rows with one index a side,
    and runs one similarity pass for all cutoffs.
    """

    def __init__(self, top_k: int, query_chunk_size: int = 1024) -> None:
        if top_k <= 0:
            raise ValueError("top_k must be positive")
        self.top_k = top_k
        self.query_chunk_size = query_chunk_size
        self.reset()

    def reset(self) -> None:
        self._batches: list[tuple] = []

    def update(
        self,
        queries,
        targets,
        indexes=None,
        valid=None,
    ) -> None:
        """Accumulate one batch.

        ``indexes[i]`` is the positive target row of query ``i`` among the
        stored (valid) targets of every batch; ``None`` pairs query ``i``
        with this batch's ``i``-th stored target. ``valid`` (a bool array
        or tensor of the batch's rows) drops padded or absent rows from the
        queries, the targets and ``indexes``; the positions count stored
        rows only, so an invalid row before a valid one shifts nothing.
        """
        self._batches.append((_rows(queries), _rows(targets), indexes, valid))

    def _masks(self) -> list[Optional[np.ndarray]]:
        """Every batch's validity mask on the host, the device ones in one
        transfer."""
        on_device = [v for _, _, _, v in self._batches
                     if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
        moved = iter([])
        if on_device:
            flat = torch.cat([v.reshape(-1).bool() for v in on_device]).cpu().numpy()
            moved = iter(np.split(flat, np.cumsum([v.numel() for v in on_device])[:-1]))
        masks = []
        for _, _, _, v in self._batches:
            if v is None:
                masks.append(None)
            elif isinstance(v, torch.Tensor) and v.device.type != "cpu":
                masks.append(next(moved))
            else:
                masks.append(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                             .reshape(-1).astype(bool))
        return masks

    def _gather(self) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """The stored (valid) queries and targets and the positive indexes."""
        masks = self._masks()
        q_rows, t_rows, idxs = [], [], []
        q_off = t_off = stored = 0
        for (q, t, ind, _), valid in zip(self._batches, masks):
            nq, nt = q.shape[0], t.shape[0]
            keep_q = np.arange(nq) if valid is None else np.flatnonzero(valid)
            keep_t = np.arange(nt) if valid is None else np.flatnonzero(valid)
            if ind is None:
                ind = np.arange(len(keep_q)) + stored
            else:
                ind = np.asarray(ind.cpu() if isinstance(ind, torch.Tensor) else ind)
                ind = ind.reshape(-1) if valid is None else ind.reshape(-1)[valid]
            q_rows.append(keep_q + q_off)
            t_rows.append(keep_t + t_off)
            idxs.append(ind.astype(np.int64))
            q_off, t_off, stored = q_off + nq, t_off + nt, stored + len(keep_t)
        queries = torch.cat([q for q, _, _, _ in self._batches])
        targets = torch.cat([t for _, t, _, _ in self._batches])
        # one index a side, moved to the rows' device once
        sel_q = torch.from_numpy(np.concatenate(q_rows)).to(queries.device)
        sel_t = torch.from_numpy(np.concatenate(t_rows)).to(targets.device)
        return queries.index_select(0, sel_q), targets.index_select(0, sel_t), np.concatenate(idxs)

    def compute(self) -> float:
        return self.compute_many([self.top_k])[self.top_k]

    def compute_many(self, ks: Sequence[int]) -> dict[int, float]:
        """Recall at every k in ``ks`` from one similarity pass: the product
        and top-k run once at ``max(ks)``, and recall@k reads the first k
        columns."""
        ks = sorted({int(k) for k in ks})
        if not self._batches:
            return {k: 0.0 for k in ks}
        queries, targets, indexes = self._gather()
        queries, targets, indexes = _gather_processes(queries, targets, indexes)
        q = l2_normalize(queries.float())
        t = l2_normalize(targets.float())
        k_max = min(max(ks), t.shape[0])
        pos = torch.from_numpy(indexes).to(q.device)
        hits = {k: torch.zeros((), dtype=torch.int64, device=q.device) for k in ks}
        with torch.inference_mode():
            for start in range(0, q.shape[0], self.query_chunk_size):
                chunk = q[start : start + self.query_chunk_size]
                match = _topk_chunk(chunk, t, k_max) == pos[start : start + len(chunk), None]
                for k in ks:
                    hits[k] += match[:, : min(k, k_max)].any(dim=1).sum()
        counts = torch.stack([hits[k] for k in ks]).cpu().tolist()
        n = q.shape[0]
        return {k: c / n if n else float("nan") for k, c in zip(ks, counts)}

    __call__ = update
