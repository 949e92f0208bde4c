"""Training and evaluation tasks of the port."""

from mmlearn_tpu_torch.tasks.contrastive_pretraining import (
    ContrastivePretraining,
    EvaluationSpec,
    ModuleKeySpec,
)
from mmlearn_tpu_torch.tasks.embedding_export import EmbeddingExport
from mmlearn_tpu_torch.tasks.hooks import EvalRuntime, EvaluationHooks
from mmlearn_tpu_torch.tasks.ijepa import IJEPA
from mmlearn_tpu_torch.tasks.zero_shot_classification import (
    ClassificationTaskSpec,
    ZeroShotClassification,
)
from mmlearn_tpu_torch.tasks.zero_shot_retrieval import (
    RetrievalTaskSpec,
    ZeroShotCrossModalRetrieval,
)

__all__ = [
    "ClassificationTaskSpec",
    "ContrastivePretraining",
    "EmbeddingExport",
    "EvalRuntime",
    "EvaluationHooks",
    "EvaluationSpec",
    "IJEPA",
    "ModuleKeySpec",
    "RetrievalTaskSpec",
    "ZeroShotClassification",
    "ZeroShotCrossModalRetrieval",
]
