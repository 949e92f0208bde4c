"""Exact inner-product top-k, counterpart of the JAX package's
``_topk_scores_chunk`` / ``_blockwise_topk_scores_chunk`` /
``_use_blockwise_topk`` (:mod:`mmlearn_tpu.modules.metrics.retrieval_recall`
:31, :51, :102). The recall metric itself is not ported yet.

Similarities are full f32 products: TF32 keeps about three decimal digits,
which cannot separate a self-similarity of 1.0 from a 0.9995-similar
neighbour, so :func:`full_f32_matmul` turns it off around every product
(the JAX package's ``Precision.HIGHEST``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

#: target-block length of the streaming exact top-k (the JAX package's)
TOPK_BLOCK = 131072

#: f32 similarity-matrix bytes above which exact top-k streams over target
#: blocks instead of materialising the whole (queries, targets) matrix
TOPK_SIM_BYTES_BUDGET = 4 << 30


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """Run float32 matmuls in full f32 (no TF32), restoring the setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _topk_scores_chunk(queries: torch.Tensor, targets: torch.Tensor, k: int):
    """Top-k (scores, target rows) of one query chunk over every target."""
    with full_f32_matmul():
        sim = queries @ targets.T
    return torch.topk(sim, k, dim=1)


def _blockwise_topk_scores_chunk(
    queries: torch.Tensor, targets: torch.Tensor, k: int, block: int
):
    """Exact top-k streamed over target blocks: per-block top-k, then one
    merge over the survivors. The (queries, targets) similarity never exists
    whole; (queries, block) is the peak."""
    scores, rows = [], []
    for start in range(0, targets.shape[0], block):
        with full_f32_matmul():
            sim = queries @ targets[start : start + block].T
        s, i = torch.topk(sim, min(k, sim.shape[1]), dim=1)
        scores.append(s)
        rows.append(i + start)
    s, i = torch.cat(scores, dim=1), torch.cat(rows, dim=1)
    top, pick = torch.topk(s, k, dim=1)
    return top, torch.gather(i, 1, pick)


def _use_blockwise_topk(num_queries: int, num_targets: int, k: int) -> bool:
    """Blockwise only when the full f32 similarity would exceed the budget
    (and a per-block top-k is well formed, k <= block)."""
    return (
        num_queries * num_targets * 4 > TOPK_SIM_BYTES_BUDGET
        and num_targets > TOPK_BLOCK >= k
    )
