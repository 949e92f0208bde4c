"""Similarity serving over exported embedding shards, counterpart of
:mod:`mmlearn_tpu.serving.index`.

:class:`EmbeddingIndex` loads the ``.npz`` shards and manifests that the JAX
package's ``EmbeddingExport`` writes (same dedup and normalization checks)
and answers exact top-k inner-product queries on its device: full-f32
similarities (no TF32) and ``torch.topk``, streamed over corpus blocks when
the whole similarity matrix would exceed the byte budget -- the JAX route,
budget and block size.

Usage::

    index = EmbeddingIndex.load("index_dir/", modality="rgb", device="cuda")
    scores, ids = index.query(query_embeddings, k=5)
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

# the module, not its values: TOPK_BLOCK / TOPK_SIM_BYTES_BUDGET are read
# through it so one setting governs every caller
from mmlearn_tpu_torch.modules.metrics import retrieval_recall as _rr
from mmlearn_tpu_torch.modules.metrics.retrieval_recall import (
    _blockwise_topk_scores_chunk,
    _topk_scores_chunk,
    _use_blockwise_topk,
)


class EmbeddingIndex:
    """Flat inner-product index over exported embedding shards."""

    def __init__(
        self,
        embeddings: np.ndarray,
        example_index: Optional[np.ndarray] = None,
        dataset_index: Optional[np.ndarray] = None,
        normalized: bool = True,
        device: torch.device | str = "cpu",
    ) -> None:
        self.device = torch.device(device)
        self.embeddings = torch.as_tensor(
            np.asarray(embeddings, np.float32), device=self.device
        )
        n = self.embeddings.shape[0]
        self.example_index = (
            np.arange(n) if example_index is None else np.asarray(example_index)
        )
        self.dataset_index = (
            np.zeros(n, np.int64) if dataset_index is None else np.asarray(dataset_index)
        )
        self.normalized = normalized

    def __len__(self) -> int:
        return int(self.embeddings.shape[0])

    @classmethod
    def load(
        cls,
        index_dir: str,
        modality: str,
        dedup: bool = True,
        device: torch.device | str = "cpu",
    ) -> "EmbeddingIndex":
        """Load every shard of one modality (all processes' manifests).

        ``dedup`` drops repeated ``(dataset_index, example_index)`` rows, as
        a multi-host export without a distributed sampler writes them.
        """
        manifests = sorted(
            f for f in os.listdir(index_dir)
            if f.startswith("manifest") and f.endswith(".json")
        )
        if not manifests:
            raise FileNotFoundError(f"no manifest*.json in {index_dir}")
        embs, ex_idx, ds_idx = [], [], []
        norm_flags = {}
        for mf in manifests:
            with open(os.path.join(index_dir, mf)) as f:
                meta = json.load(f)
            if modality not in meta:
                continue
            norm_flags[mf] = bool(meta[modality].get("normalized", True))
            for shard in meta[modality]["shards"]:
                with np.load(os.path.join(index_dir, shard)) as z:
                    embs.append(z["embeddings"].astype(np.float32))
                    ex_idx.append(z["example_index"])
                    ds_idx.append(z["dataset_index"])
        if not embs:
            raise ValueError(f"no '{modality}' shards listed in {manifests}")
        if len(set(norm_flags.values())) > 1:
            raise ValueError(
                "manifests disagree on 'normalized' -- cosine and raw "
                f"inner-product shards cannot be merged: {norm_flags}"
            )
        emb = np.concatenate(embs)
        ex = np.concatenate(ex_idx)
        ds = np.concatenate(ds_idx)
        if dedup:
            _, keep = np.unique(
                np.stack([ds.astype(np.int64), ex.astype(np.int64)]),
                axis=1, return_index=True,
            )
            if len(keep) < len(ex):
                keep = np.sort(keep)
                emb, ex, ds = emb[keep], ex[keep], ds[keep]
        return cls(emb, ex, ds, normalized=next(iter(norm_flags.values())),
                   device=device)

    def query(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int = 10,
        chunk_size: int = 8192,
        approx: bool = False,
        block_size: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k (scores, example ids) per query row.

        Queries should be L2-normalised iff the index is. Chunked over
        queries to bound device memory. ``approx=True`` is answered exactly:
        the JAX package's ``approx_max_k`` is exact off the TPU too, and the
        port has no approximate search yet. A chunk whose f32 similarity
        would exceed the byte budget streams over corpus blocks (still
        exact); ``block_size`` forces that with the given block when it is
        usable (``k <= block_size < len``).
        """
        del approx  # exact either way (see above)
        k = min(int(k), len(self))
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        forced = block_size is not None and len(self) > block_size >= k
        scores, rows = [], []
        with torch.inference_mode():
            for start in range(0, q.shape[0], chunk_size):
                qc = q[start : start + chunk_size]
                if forced or _use_blockwise_topk(qc.shape[0], len(self), k):
                    # an unusable block_size keeps the memory routing
                    s, i = _blockwise_topk_scores_chunk(
                        qc, self.embeddings, k, block_size if forced else _rr.TOPK_BLOCK
                    )
                else:
                    s, i = _topk_scores_chunk(qc, self.embeddings, k)
                scores.append(s.cpu().numpy())
                rows.append(i.cpu().numpy())
        return np.concatenate(scores), self.example_index[np.concatenate(rows)]
