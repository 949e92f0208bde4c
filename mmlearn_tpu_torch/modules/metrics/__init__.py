"""Evaluation metrics of the port: Recall@K with its exact top-k, and the
classification metrics."""

from mmlearn_tpu_torch.modules.metrics.classification import (
    binary_f1,
    binary_precision,
    binary_recall,
    macro_auroc,
    macro_f1,
    macro_precision,
    macro_recall,
    top_k_accuracy,
)
from mmlearn_tpu_torch.modules.metrics.retrieval_recall import RetrievalRecallAtK

__all__ = [
    "RetrievalRecallAtK",
    "binary_f1",
    "binary_precision",
    "binary_recall",
    "macro_auroc",
    "macro_f1",
    "macro_precision",
    "macro_recall",
    "top_k_accuracy",
]
