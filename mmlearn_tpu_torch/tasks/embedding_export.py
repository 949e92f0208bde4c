"""Embedding export: encoder outputs written to disk as a retrieval index,
counterpart of :mod:`mmlearn_tpu.tasks.embedding_export`.

Encoding a corpus once and serving similarity queries against the stored
vectors is how a contrastive model is served; this evaluation task writes
the index that :class:`~mmlearn_tpu_torch.serving.EmbeddingIndex` loads, in
the JAX package's layout:

- per modality, shards ``"{modality}_{i:05d}.npz"`` holding
  ``embeddings`` (``float32``, or ``float16`` when asked: raw features can
  overflow it, so the narrowing is never implicit), ``example_index`` and
  ``dataset_index`` (``int32``); only valid rows (present, not padding) are
  written;
- ``manifest.json``: per modality its ``shards``, ``rows``, ``dim`` and
  whether the rows are ``normalized``.

Over several processes (the batch split over ``data x fsdp``) each process
writes its own rows, its shard names and its manifest suffixed ``_p{rank}``
(``rgb_p1_00000.npz``, ``manifest_p1.json``), as the JAX package's
(:102-186); ``EmbeddingIndex.load`` reads every manifest. Disjoint coverage
takes a distributed eval sampler (``DistributedEvalSampler``). The ranks of
a ``seq`` or ``model`` group hold the same rows: the first of them writes.

Embeddings stay on the device until a shard is flushed (``shard_size``
rows or the epoch's end): then the shard's embeddings cross to the host in
one copy, its indices and validity in another.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch


def _suffix() -> str:
    """``_p{rank}`` among the batch's shards over several processes, else
    nothing."""
    from mmlearn_tpu_torch.parallel.collectives import axis_index, axis_size

    return f"_p{axis_index()}" if axis_size() > 1 else ""


def _writes() -> bool:
    """Whether this rank writes its rows: the first rank of its ``seq x
    model`` group (the axes after ``fsdp``), whose ranks hold the same rows."""
    from mmlearn_tpu_torch.parallel.mesh import peek_global_mesh

    mesh = peek_global_mesh()
    return mesh is None or mesh.rank % (mesh.size // mesh.dp_size) == 0

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import DATASET_INDEX_KEY, EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.tasks.base import as_tensor
from mmlearn_tpu_torch.tasks.hooks import EvalRuntime, EvaluationHooks, row_validity


@store(group="eval_task", name="EmbeddingExport", populate_full_signature=False)
class EmbeddingExport(EvaluationHooks):
    """Write per-modality embedding shards for serving.

    Args:
        output_dir: directory of the shards and the manifest (created).
        modalities: the modalities to export (default: all the task has).
        normalize: L2-normalize the embeddings (the similarity-serving
            layout).
        shard_size: rows a shard; bounds the device and host memory held.
        dtype: on-disk dtype, ``float32`` or ``float16``.
    """

    def __init__(
        self,
        output_dir: str,
        modalities: Optional[Sequence[str]] = None,
        normalize: bool = True,
        shard_size: int = 65536,
        dtype: str = "float32",
    ) -> None:
        self.output_dir = output_dir
        if modalities is not None and not list(modalities):
            raise ValueError(
                "EmbeddingExport: modalities=[] exports nothing; pass None "
                "to export every modality in the batch"
            )
        self.modalities = (
            [str(m).lower() for m in modalities] if modalities is not None else None
        )
        self.normalize = bool(normalize)
        self.shard_size = int(shard_size)
        if dtype not in ("float32", "float16"):
            raise ValueError(f"EmbeddingExport dtype must be float32 or float16, got {dtype!r}")
        self.dtype = np.dtype(dtype)
        self._buffers: dict[str, list] = {}
        self._manifest: dict[str, Any] = {}
        self._consumed: dict[str, int] = {}

    # -- hooks --------------------------------------------------------------------
    def on_evaluation_epoch_start(self, runtime: EvalRuntime) -> None:
        self._buffers = {}
        self._consumed = {}
        mods = self.modalities or [str(m).lower() for m in runtime.task.modalities]
        self._manifest = {
            m: {"shards": [], "rows": 0, "dim": None, "normalized": self.normalize}
            for m in mods
        }
        os.makedirs(self.output_dir, exist_ok=True)

    def evaluation_step(
        self, runtime: EvalRuntime, batch: Mapping[str, Any], batch_idx: int
    ) -> None:
        device = runtime.device
        for mod in self._manifest:
            key = Modalities.get_modality(mod).name
            if key not in batch:
                continue
            emb = runtime.encode(batch, mod, normalize=self.normalize)
            n = emb.shape[0]
            valid = row_validity(batch, (key,), n, device)
            if valid is None:
                valid = torch.ones(n, dtype=torch.bool, device=device)
            if EXAMPLE_INDEX_KEY in batch:
                ex_idx = as_tensor(batch[EXAMPLE_INDEX_KEY], device).reshape(-1)[:n]
            else:
                # datasets that stamp no index: consumption order, unique
                # across batches
                seen = self._consumed.get(mod, 0)
                ex_idx = torch.arange(seen, seen + n, device=device)
            self._consumed[mod] = self._consumed.get(mod, 0) + n
            ds_idx = as_tensor(batch.get(DATASET_INDEX_KEY, np.zeros(n, np.int64)),
                               device).reshape(-1)[:n]
            buf = self._buffers.setdefault(mod, [])
            buf.append((emb, valid, ex_idx, ds_idx))
            if sum(b[0].shape[0] for b in buf) >= self.shard_size:
                self._flush(mod)

    def on_evaluation_epoch_end(self, runtime: EvalRuntime) -> dict[str, Any]:
        results: dict[str, Any] = {}
        for mod in list(self._manifest):
            if self._buffers.get(mod):
                self._flush(mod)
            results[f"export/{mod}_rows"] = self._manifest[mod]["rows"]
        if _writes():
            with open(os.path.join(self.output_dir, f"manifest{_suffix()}.json"), "w") as f:
                json.dump(self._manifest, f, indent=2)
        self._buffers = {}
        return results

    # -- internals ---------------------------------------------------------------
    def _flush(self, mod: str) -> None:
        buf = self._buffers.pop(mod, [])
        if not buf:
            return
        emb = torch.cat([b[0] for b in buf]).float().cpu().numpy().astype(self.dtype)
        meta = torch.stack([torch.cat([b[i].long() for b in buf]) for i in (1, 2, 3)])
        valid, ex_idx, ds_idx = meta.cpu().numpy()
        valid = valid.astype(bool)
        # int32, as the JAX package's trainer batches hold them (JAX's
        # default 32-bit integers)
        ex_idx, ds_idx = ex_idx.astype(np.int32), ds_idx.astype(np.int32)
        # padded and absent rows never reach the disk
        emb, ex_idx, ds_idx = emb[valid], ex_idx[valid], ds_idx[valid]
        m = self._manifest[mod]
        name = f"{mod}{_suffix()}_{len(m['shards']):05d}.npz"
        if _writes():
            np.savez(os.path.join(self.output_dir, name), embeddings=emb,
                     example_index=ex_idx, dataset_index=ds_idx)
        m["shards"].append(name)
        m["rows"] += int(emb.shape[0])
        m["dim"] = int(emb.shape[1])
