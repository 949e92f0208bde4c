"""Data2Vec regression loss, counterpart of
:mod:`mmlearn_tpu.modules.losses.data2vec`: scaled MSE or smooth-L1 between
predicted and target embeddings."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from mmlearn_tpu_torch.conf import store


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise: ``0.5 diff^2 / beta`` below ``beta``, ``|diff| - 0.5
    beta`` above."""
    diff = pred - target
    abs_diff = diff.abs()
    return torch.where(abs_diff < beta, 0.5 * diff**2 / beta, abs_diff - 0.5 * beta)


@store(group="modules/losses", name="Data2VecLoss", populate_full_signature=False)
@dataclass
class Data2VecLoss:
    """MSE (``beta = 0``) or smooth-L1 (``beta > 0``) over embeddings, in f32,
    times ``loss_scale`` (default ``1 / sqrt(dim)``). ``reduction``:
    ``"none"`` (per-row sums over the features), ``"mean"`` or ``"sum"``."""

    beta: float = 0.0
    loss_scale: Optional[float] = None
    reduction: str = "none"

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape != y.shape:
            raise ValueError(f"Shape mismatch: x: {tuple(x.shape)}, y: {tuple(y.shape)}")
        x = x.reshape(-1, x.shape[-1]).float()
        y = y.reshape(-1, y.shape[-1]).float()
        loss = (x - y) ** 2 if self.beta == 0.0 else smooth_l1(x, y, self.beta)
        scale = self.loss_scale if self.loss_scale is not None else 1.0 / (x.shape[-1] ** 0.5)
        loss = loss * scale
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss.sum(dim=-1)
