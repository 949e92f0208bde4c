"""Taxonomic classification (BIOSCAN-CLIP), counterpart of
``projects.bioscan_clip.eval_task``.

Gathers rgb, dna and text embeddings (and their ``averaged`` and
``concatenated`` forms) per BIOSCAN split, predicts the taxonomy of the
``val_seen``/``val_unseen`` queries by exact inner-product kNN over the
``all_keys`` gallery, and reports micro and macro top-k accuracy per
taxonomic level. The kNN runs where the embeddings are (the card, through
:class:`~mmlearn_tpu_torch.tasks.hooks.EvalRuntime`): L2-normalised f32 rows
and the retrieval metric's exact top-k, which puts the lower key row first
among equal scores (``jax.lax.top_k``'s order). The JAX task's gather across
processes waits for the port's multi-host layer.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize
from mmlearn_tpu_torch.modules.metrics.retrieval_recall import _topk_chunk, full_f32_matmul
from mmlearn_tpu_torch.tasks.base import as_tensor
from mmlearn_tpu_torch.tasks.hooks import EvalRuntime, EvaluationHooks

logger = logging.getLogger(__name__)

LEVELS = ("order", "family", "genus", "species")


def _labels_to_list(labels: Any, n: int) -> list[dict[str, str]]:
    """Collated labels as a list of per-example taxonomy dicts."""
    if isinstance(labels, Mapping):
        return [{level: str(labels[level][i]) for level in LEVELS if level in labels}
                for i in range(n)]
    return [dict(d) for d in labels]


def knn_predict(queries: Any, keys: Any, key_labels: list[dict[str, str]], max_k: int,
                chunk: int = 1024) -> list[dict[str, list[str]]]:
    """The labels of each query's ``max_k`` nearest keys by inner product of
    the L2-normalised f32 rows (the reference's ``faiss.IndexFlatIP``), on
    the device of ``queries`` where it is a tensor."""
    device = queries.device if isinstance(queries, torch.Tensor) else torch.device("cpu")
    q = l2_normalize(as_tensor(queries, device).float())
    t = l2_normalize(as_tensor(keys, device).float())
    k = min(max_k, t.shape[0])
    preds: list[dict[str, list[str]]] = []
    with full_f32_matmul():
        for start in range(0, q.shape[0], chunk):
            for row in _topk_chunk(q[start : start + chunk], t, k).cpu().numpy():
                preds.append({level: [key_labels[i][level] for i in row] for level in LEVELS})
    return preds


def top_k_micro_accuracy(pred_list: Sequence[dict], gt_list: Sequence[dict],
                         k_list: Sequence[int]) -> dict[int, dict[str, float]]:
    """The share of queries whose label is among their top-k predictions."""
    out: dict[int, dict[str, float]] = {}
    for k in k_list:
        out[k] = {}
        for level in LEVELS:
            correct = sum(1 for pred, gt in zip(pred_list, gt_list) if gt[level] in pred[level][:k])
            out[k][level] = correct / max(1, len(pred_list))
    return out


def top_k_macro_accuracy(pred_list: Sequence[dict], gt_list: Sequence[dict],
                         k_list: Sequence[int]) -> tuple[dict, dict]:
    """The per-class recall averaged over classes, and the per-class table."""
    macro: dict[int, dict[str, float]] = {}
    per_class: dict[int, dict[str, dict[str, float]]] = {}
    for k in k_list:
        macro[k], per_class[k] = {}, {}
        for level in LEVELS:
            hit: dict[str, int] = {}
            total: dict[str, int] = {}
            for pred, gt in zip(pred_list, gt_list):
                label = gt[level]
                total[label] = total.get(label, 0) + 1
                if label in pred[level][:k]:
                    hit[label] = hit.get(label, 0) + 1
            per_class[k][level] = {label: hit.get(label, 0) / cnt for label, cnt in total.items()}
            macro[k][level] = (sum(per_class[k][level].values()) / len(total)) if total else 0.0
    return macro, per_class


@external_store(group="eval_task", name="TaxonomicClassification",
                populate_full_signature=False)
class TaxonomicClassification(EvaluationHooks):
    """kNN taxonomic classification over BIOSCAN splits. A batch carries
    ``rgb`` and ``dna`` (``text`` too for the ``all_key`` gallery),
    ``split`` (one name a row) and ``labels`` (taxonomy dicts, or a mapping
    of level to a column). Metrics are named
    ``{split}_{query}_2_{key}_top_{k}_{micro|macro}_{level}``."""

    def __init__(
        self,
        top_k: Sequence[int] = (1,),
        query_splits: Sequence[str] = ("val_seen", "val_unseen"),
        key_split: str = "all_keys",
        report_combos: Sequence[Sequence[str]] = (("rgb", "dna"),),
        print_table: bool = True,
    ) -> None:
        self.top_k = [int(k) for k in top_k]
        self.query_splits = list(query_splits)
        self.key_split = key_split
        self.report_combos = [tuple(c) for c in report_combos]
        self.print_table = bool(print_table)
        self._store: dict[str, dict[str, list]] = {}

    def on_evaluation_epoch_start(self, runtime: EvalRuntime) -> None:
        self._store = {}

    def evaluation_step(self, runtime: EvalRuntime, batch: Mapping[str, Any],
                        batch_idx: int) -> None:
        if any(m not in batch for m in ("rgb", "dna")):
            return
        emb = {m: runtime.encode(batch, m, normalize=True)
               for m in ("rgb", "dna", "text") if m in batch}
        emb["averaged"] = (emb["rgb"] + emb["dna"]) / 2.0
        emb["concatenated"] = torch.cat([emb["rgb"], emb["dna"]], dim=1)
        n = emb["rgb"].shape[0]
        splits = batch.get("split")
        if splits is None:
            splits = ["no_split"] * n
        labels = _labels_to_list(batch.get("labels", [{}] * n), n)
        valid = np.ones(n, dtype=bool)
        if "batch_validity" in batch:
            valid = np.asarray(as_tensor(batch["batch_validity"], torch.device("cpu"))).astype(bool)
        for split in set(splits):
            sel = np.asarray([s == split for s in splits]) & valid
            if not sel.any():
                continue
            rows = torch.as_tensor(np.flatnonzero(sel), device=emb["rgb"].device)
            store = self._store.setdefault(split, {})
            for key, value in emb.items():
                store.setdefault(key, []).append(value[rows])
            sel_labels = [lab for lab, s in zip(labels, sel) if s]
            store.setdefault("labels", []).extend(sel_labels)
            if split == self.key_split and "text" in emb:
                store.setdefault("all_key", []).append(
                    torch.cat([emb["rgb"][rows], emb["dna"][rows], emb["text"][rows]]))
                store.setdefault("all_key_labels", []).extend(sel_labels * 3)

    def on_evaluation_epoch_end(self, runtime: EvalRuntime) -> dict[str, float]:
        if not self._store or self.key_split not in self._store:
            return {}
        keys_store = self._store[self.key_split]
        cat = {k: torch.cat(v) for k, v in keys_store.items()
               if k not in ("labels", "all_key_labels", "all_key")}
        max_k = max(self.top_k)
        results: dict[str, float] = {}
        for split in self.query_splits:
            if split not in self._store:
                continue
            qstore = self._store[split]
            q_emb = {k: torch.cat(v) for k, v in qstore.items() if k != "labels"}
            gt = qstore["labels"]
            for q_type, k_type in self.report_combos:
                if q_type not in q_emb:
                    continue
                if k_type == "all_key":
                    if "all_key" not in keys_store:
                        continue
                    keys, k_labels = torch.cat(keys_store["all_key"]), keys_store["all_key_labels"]
                else:
                    if k_type not in cat:
                        continue
                    keys, k_labels = cat[k_type], keys_store["labels"]
                if keys.shape[-1] != q_emb[q_type].shape[-1]:
                    continue
                preds = knn_predict(q_emb[q_type], keys, k_labels, max_k)
                micro = top_k_micro_accuracy(preds, gt, self.top_k)
                macro, _ = top_k_macro_accuracy(preds, gt, self.top_k)
                for k in self.top_k:
                    for level in LEVELS:
                        name = f"{split}_{q_type}_2_{k_type}_top_{k}"
                        results[f"{name}_micro_{level}"] = micro[k][level]
                        results[f"{name}_macro_{level}"] = macro[k][level]
        self._store.clear()
        if self.print_table and results:
            _log_accuracy_table(results)
        return results


def _log_accuracy_table(results: Mapping[str, float]) -> None:
    """One row a (query to key, accuracy type, k), one column a (split,
    level)."""
    parsed = []
    for key, value in results.items():
        m = re.match(r"(?P<split>.+)_(?P<q>rgb|dna|text|averaged|concatenated)_2_"
                     r"(?P<k>rgb|dna|text|averaged|concatenated|all_key)_top_"
                     r"(?P<n>\d+)_(?P<type>micro|macro)_(?P<level>order|family|genus|species)$",
                     key)
        if m:
            parsed.append((m.groupdict(), value))
    if not parsed:
        return
    splits = sorted({p["split"] for p, _ in parsed})
    rows: dict[tuple, dict] = {}
    for p, value in parsed:
        rows.setdefault((f"{p['q']}->{p['k']}", p["type"], int(p["n"])), {})[
            (p["split"], p["level"])] = value
    cols = [(s, lv) for s in splits for lv in LEVELS]
    lines = [f"{'query->key (acc, k)':34s} | " + " | ".join(f"{s[:6]}.{lv[:4]}" for s, lv in cols)]
    for (combo, acc_type, k), cells in sorted(rows.items()):
        vals = " | ".join(f"{cells.get(c, float('nan')):11.4f}" for c in cols)
        lines.append(f"{combo + f' ({acc_type} top-{k})':34s} | {vals}")
    logger.info("taxonomic classification results:\n%s", "\n".join(lines))
