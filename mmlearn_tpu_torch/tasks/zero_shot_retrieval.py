"""Zero-shot cross-modal retrieval, counterpart of
:mod:`mmlearn_tpu.tasks.zero_shot_retrieval`.

For each ``(query_modality, target_modality)`` direction one
:class:`~mmlearn_tpu_torch.modules.metrics.RetrievalRecallAtK` accumulates
both modalities' un-normalized embeddings of every batch, paired row for
row, on the device; at the epoch's end one similarity pass gives recall at
every k asked for that direction (``retrieval/<q>_to_<t>_R@<k>``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.modules.metrics.retrieval_recall import RetrievalRecallAtK
from mmlearn_tpu_torch.tasks.hooks import EvalRuntime, EvaluationHooks, row_validity


@dataclass
class RetrievalTaskSpec:
    """One retrieval direction and its cutoffs."""

    query_modality: str = "rgb"
    target_modality: str = "text"
    top_k: Sequence[int] = field(default_factory=lambda: [10])


@store(group="eval_task", name="ZeroShotCrossModalRetrieval", populate_full_signature=False)
class ZeroShotCrossModalRetrieval(EvaluationHooks):
    """Recall@K for each configured cross-modal retrieval direction."""

    def __init__(self, task_specs: Sequence[RetrievalTaskSpec | Mapping]) -> None:
        self.task_specs = [
            spec if isinstance(spec, RetrievalTaskSpec) else RetrievalTaskSpec(**spec)
            for spec in task_specs
        ]
        # one metric a direction: every cutoff shares the accumulated
        # embeddings and one similarity pass (compute_many)
        self._ks: dict[tuple, list[int]] = {}
        for spec in self.task_specs:
            q = str(spec.query_modality).lower()
            t = str(spec.target_modality).lower()
            self._ks.setdefault((q, t), []).extend(int(k) for k in spec.top_k)
        self.metrics: dict[tuple, RetrievalRecallAtK] = {
            pair: RetrievalRecallAtK(top_k=max(ks)) for pair, ks in self._ks.items()
        }

    def on_evaluation_epoch_start(self, runtime: EvalRuntime) -> None:
        for metric in self.metrics.values():
            metric.reset()

    def evaluation_step(
        self, runtime: EvalRuntime, batch: Mapping[str, Any], batch_idx: int
    ) -> None:
        cache: dict[str, Any] = {}
        for (q, t), metric in self.metrics.items():
            q_key = Modalities.get_modality(q).name
            t_key = Modalities.get_modality(t).name
            if q_key not in batch or t_key not in batch:
                continue
            for mod in (q, t):
                if mod not in cache:
                    cache[mod] = runtime.encode(batch, mod, normalize=False)
            valid = row_validity(batch, (q_key, t_key), len(cache[q]), cache[q].device)
            metric.update(cache[q], cache[t], indexes=None, valid=valid)

    def on_evaluation_epoch_end(self, runtime: EvalRuntime) -> dict[str, float]:
        results = {}
        for (q, t), metric in self.metrics.items():
            for k, value in metric.compute_many(self._ks[(q, t)]).items():
                results[f"retrieval/{q}_to_{t}_R@{k}"] = value
            metric.reset()
        return results
