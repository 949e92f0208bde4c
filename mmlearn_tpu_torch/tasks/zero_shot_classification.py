"""Zero-shot classification, counterpart of
:mod:`mmlearn_tpu.tasks.zero_shot_classification`.

At the epoch's start each eval sub-dataset with ``id2label`` and
``zero_shot_prompt_templates`` gets class embeddings: every (class,
template) prompt is tokenized and encoded in chunks of ``batch_size``,
normalized, averaged over the templates and normalized again, row ``i``
for class id ``i`` (keys sorted by their numeric value). Each batch's
examples are routed to their own sub-dataset by ``dataset_index``: a
multi-class set scores ``100 * embedding @ classes.T``, a 2-class set the
softmax difference ``p(1) - p(0)`` of the raw cosines. Scores and class
embeddings are f32 on the device (full-f32 products), kept with each
batch's selection mask; the epoch's end moves them to the host once and
computes accuracy (top-k for multi-class), precision, recall, F1 and AUROC
(``classification/ds<i>_<modality>_<metric>``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import DATASET_INDEX_KEY
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize
from mmlearn_tpu_torch.modules.metrics.classification import (
    _binary_auroc,
    binary_f1,
    binary_precision,
    binary_recall,
    macro_auroc,
    macro_f1,
    macro_precision,
    macro_recall,
    top_k_accuracy,
)
from mmlearn_tpu_torch.modules.metrics.retrieval_recall import full_f32_matmul
from mmlearn_tpu_torch.tasks.base import as_tensor
from mmlearn_tpu_torch.tasks.hooks import EvalRuntime, EvaluationHooks, row_validity


@dataclass
class ClassificationTaskSpec:
    """The query modality and the top-k accuracies to report."""

    query_modality: str = "rgb"
    top_k: Sequence[int] = field(default_factory=lambda: [1])


def _gathered(scores: dict) -> dict:
    """``{(modality, dataset): (scores, targets, selected)}`` as numpy, each
    process's rows concatenated in rank order over the batch's shards (the
    union of the keys every process saw; one process keeps its own)."""
    from mmlearn_tpu_torch.parallel.collectives import axis_size, process_allgather_object

    local = {key: tuple(torch.cat([c[i] for c in chunks]).cpu().numpy() for i in range(3))
             for key, chunks in scores.items()}
    if axis_size() == 1:
        return local
    parts = process_allgather_object(local)
    keys = sorted({key for part in parts for key in part}, key=str)
    return {key: tuple(np.concatenate([part[key][i] for part in parts if key in part])
                       for i in range(3)) for key in keys}


@store(group="eval_task", name="ZeroShotClassification", populate_full_signature=False)
class ZeroShotClassification(EvaluationHooks):
    """Zero-shot classification against prompt-template class embeddings."""

    def __init__(
        self,
        task_specs: Sequence[ClassificationTaskSpec | Mapping],
        tokenizer: Optional[Callable] = None,
        batch_size: int = 64,
    ) -> None:
        self.task_specs = [
            spec if isinstance(spec, ClassificationTaskSpec) else ClassificationTaskSpec(**spec)
            for spec in task_specs
        ]
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        #: dataset index -> (classes, dim) f32 class embeddings on the device
        self._class_embeddings: dict[int, torch.Tensor] = {}
        #: (query modality, dataset index) -> each batch's (scores, targets,
        #: selected rows), on the device
        self._scores: dict[tuple, list[tuple[torch.Tensor, ...]]] = {}

    # -- class-prompt embedding -------------------------------------------------
    def _dataset_info(self, runtime: EvalRuntime) -> dict[int, dict]:
        """``id2label`` and the prompt templates of each eval sub-dataset
        that has both, by its index in ``runtime.dataloader.dataset``."""
        info: dict[int, dict] = {}
        loader = getattr(runtime, "dataloader", None)
        dataset = getattr(loader, "dataset", None)
        sub_datasets = getattr(dataset, "datasets", [dataset] if dataset else [])
        for idx, ds in enumerate(sub_datasets):
            id2label = getattr(ds, "id2label", None)
            templates = getattr(ds, "zero_shot_prompt_templates", None)
            if id2label and templates:
                info[idx] = {"id2label": id2label, "templates": templates}
        return info

    def on_evaluation_epoch_start(self, runtime: EvalRuntime) -> None:
        if self.tokenizer is None:
            raise ValueError("ZeroShotClassification requires a tokenizer to embed prompts")
        self._class_embeddings.clear()
        self._scores.clear()
        for ds_idx, meta in self._dataset_info(runtime).items():
            id2label, templates = meta["id2label"], meta["templates"]
            # row i holds class id i: numeric order (JSON keys are strings,
            # and '10' sorts before '2')
            try:
                keys = sorted(id2label, key=lambda k: int(k))
            except (TypeError, ValueError):
                keys = list(id2label)  # non-numeric keys: insertion order
            labels = [id2label[k] for k in keys]
            prompts = [t.format(label) for label in labels for t in templates]
            embs = []
            for start in range(0, len(prompts), self.batch_size):
                tokens = self.tokenizer(prompts[start : start + self.batch_size])
                embs.append(runtime.encode(tokens, "text", normalize=True).float())
            embs = torch.cat(embs).reshape(len(labels), len(templates), -1)
            self._class_embeddings[ds_idx] = l2_normalize(embs.mean(dim=1))

    # -- per batch --------------------------------------------------------------
    def evaluation_step(
        self, runtime: EvalRuntime, batch: Mapping[str, Any], batch_idx: int
    ) -> None:
        if not self._class_embeddings:
            return
        device = runtime.device
        ds_indices = as_tensor(batch.get(DATASET_INDEX_KEY, np.zeros(1, np.int64)),
                               device).reshape(-1)
        for spec in self.task_specs:
            q = str(spec.query_modality).lower()
            mod = Modalities.get_modality(q)
            if mod.name not in batch or mod.target not in batch:
                continue
            emb = runtime.encode(batch, q, normalize=True).float()
            targets = as_tensor(batch[mod.target], device).reshape(-1)
            valid = row_validity(batch, (mod.name,), len(emb), device)
            for ds_idx, class_emb in self._class_embeddings.items():
                sel = ds_indices == ds_idx
                if valid is not None:
                    sel = valid & sel
                with full_f32_matmul(), torch.inference_mode():
                    if class_emb.shape[0] == 2:
                        # binary sets: softmax-difference scores in [-1, 1],
                        # 1-D so the epoch's end takes the binary metrics
                        probs = torch.softmax(emb @ class_emb.T, dim=1)
                        scores = probs[:, 1] - probs[:, 0]
                    else:
                        scores = 100.0 * emb @ class_emb.T
                self._scores.setdefault((q, ds_idx), []).append(
                    (scores, targets, sel.expand(len(emb))))

    def on_evaluation_epoch_end(self, runtime: EvalRuntime) -> dict[str, float]:
        """Accuracy, precision, recall, F1 and AUROC a dataset (macro over
        classes; binary for 2-class sets)."""
        top_k_by_q = {
            str(s.query_modality).lower(): [int(k) for k in s.top_k] for s in self.task_specs
        }
        results: dict[str, float] = {}
        for (q, ds_idx), (scores, targets, sel) in _gathered(self._scores).items():
            if not sel.any():
                continue  # no example of this dataset reached the epoch
            scores = scores[sel]
            targets = targets[sel].astype(np.int64)
            prefix = f"classification/ds{ds_idx}_{q}"
            if scores.ndim == 1:
                # binary: sigmoid(score) > 0.5 <=> score > 0
                preds = (scores > 0).astype(np.int64)
                results[f"{prefix}_accuracy"] = float((preds == targets).mean())
                results[f"{prefix}_precision"] = binary_precision(preds, targets)
                results[f"{prefix}_recall"] = binary_recall(preds, targets)
                results[f"{prefix}_f1"] = binary_f1(preds, targets)
                auroc = _binary_auroc(scores, targets.astype(bool))
                if auroc is not None:
                    results[f"{prefix}_auroc"] = auroc
                continue
            num_classes = scores.shape[1]
            for k in top_k_by_q.get(q, [1]):
                results[f"{prefix}_top{k}_accuracy"] = top_k_accuracy(scores, targets, k)
            preds = scores.argmax(axis=1)
            results[f"{prefix}_precision"] = macro_precision(preds, targets, num_classes)
            results[f"{prefix}_recall"] = macro_recall(preds, targets, num_classes)
            results[f"{prefix}_f1"] = macro_f1(preds, targets, num_classes)
            auroc = macro_auroc(scores, targets, num_classes)
            if auroc is not None:
                results[f"{prefix}_auroc"] = auroc
        self._class_embeddings.clear()
        self._scores.clear()
        return results
