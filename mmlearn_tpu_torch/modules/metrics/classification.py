"""Classification metrics (accuracy, precision, recall, F1, AUROC), a copy of
:mod:`mmlearn_tpu.modules.metrics.classification` (the port imports nothing
of the JAX package).

Zero-shot classification is scored with torchmetrics' Accuracy, Precision,
Recall, F1 and AUROC in the original; these are small host-side
computations, so plain numpy keeps them dependency-free. Every multiclass
variant is macro-averaged over classes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def top_k_accuracy(
    scores: np.ndarray, targets: np.ndarray, k: int = 1
) -> float:
    order = np.argsort(-scores, axis=1)[:, :k]
    return float((order == targets[:, None]).any(axis=1).mean())


def _confusion_counts(
    preds: np.ndarray, targets: np.ndarray, num_classes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((preds == c) & (targets == c))
        fp[c] = np.sum((preds == c) & (targets != c))
        fn[c] = np.sum((preds != c) & (targets == c))
    return tp, fp, fn


# NOTE: macro averages run over classes PRESENT IN TARGETS only — this
# matches torchmetrics >= 1.0 (the reference locks 1.6.2, uv.lock), whose
# _adjust_weights_safe_divide zero-weights support-less classes for
# average="macro". Pre-1.0 torchmetrics averaged over all classes.


def macro_precision(preds: np.ndarray, targets: np.ndarray, num_classes: int) -> float:
    tp, fp, _ = _confusion_counts(preds, targets, num_classes)
    denom = tp + fp
    per_class = np.divide(tp, denom, out=np.zeros_like(tp), where=denom > 0)
    present = np.isin(np.arange(num_classes), targets)
    return float(per_class[present].mean()) if present.any() else 0.0


def macro_recall(preds: np.ndarray, targets: np.ndarray, num_classes: int) -> float:
    tp, _, fn = _confusion_counts(preds, targets, num_classes)
    denom = tp + fn
    per_class = np.divide(tp, denom, out=np.zeros_like(tp), where=denom > 0)
    present = np.isin(np.arange(num_classes), targets)
    return float(per_class[present].mean()) if present.any() else 0.0


def macro_f1(preds: np.ndarray, targets: np.ndarray, num_classes: int) -> float:
    tp, fp, fn = _confusion_counts(preds, targets, num_classes)
    denom = 2 * tp + fp + fn
    per_class = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    present = np.isin(np.arange(num_classes), targets)
    return float(per_class[present].mean()) if present.any() else 0.0


def binary_precision(preds: np.ndarray, targets: np.ndarray) -> float:
    """Precision of the positive class (torchmetrics task='binary')."""
    tp = np.sum((preds == 1) & (targets == 1))
    fp = np.sum((preds == 1) & (targets != 1))
    return float(tp / (tp + fp)) if (tp + fp) > 0 else 0.0


def binary_recall(preds: np.ndarray, targets: np.ndarray) -> float:
    """Recall of the positive class (torchmetrics task='binary')."""
    tp = np.sum((preds == 1) & (targets == 1))
    fn = np.sum((preds != 1) & (targets == 1))
    return float(tp / (tp + fn)) if (tp + fn) > 0 else 0.0


def binary_f1(preds: np.ndarray, targets: np.ndarray) -> float:
    """F1 of the positive class (torchmetrics task='binary')."""
    tp = np.sum((preds == 1) & (targets == 1))
    fp = np.sum((preds == 1) & (targets != 1))
    fn = np.sum((preds != 1) & (targets == 1))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def _binary_auroc(scores: np.ndarray, labels: np.ndarray) -> Optional[float]:
    """AUROC via the rank-sum (Mann-Whitney U) formulation."""
    pos = labels.astype(bool)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return None
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    rank_sum = ranks[pos].sum()
    u = rank_sum - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def macro_auroc(
    scores: np.ndarray, targets: np.ndarray, num_classes: int
) -> Optional[float]:
    """One-vs-rest AUROC macro-averaged over classes present in targets."""
    aucs = []
    for c in range(num_classes):
        auc = _binary_auroc(scores[:, c], targets == c)
        if auc is not None:
            aucs.append(auc)
    return float(np.mean(aucs)) if aucs else None
