"""Exponential moving average of a module's weights, counterpart of
:mod:`mmlearn_tpu.modules.ema`.

``ema = d * ema + (1 - d) * new`` each step, with ``d`` annealed linearly
from ``ema_decay`` to ``ema_end_decay`` over ``ema_anneal_end_step``
updates. The JAX package maps a pure function over parameter trees; here
:meth:`ExponentialMovingAverage.step` updates the teacher module's f32
weights in place (``torch._foreach_mul_`` then ``_foreach_add_``: the same
two products and one sum, where ``lerp`` would round otherwise).

``skip_keys``: parameters whose name (the port's dotted name, such as
``blocks.0.attn.qkv.weight``) contains one of these strings take the
student's value instead of the average.

Under FSDP2 (and a ``model`` split) the teacher is sharded exactly as the
student, so the update is elementwise on each rank's local shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class ExponentialMovingAverage:
    """EMA schedule and in-place update of a teacher module."""

    ema_decay: float = 0.9998
    ema_end_decay: float = 0.9999
    ema_anneal_end_step: int = 300000
    skip_keys: tuple[str, ...] = ()

    def get_annealed_rate(self, num_updates: int) -> float:
        """The decay after ``num_updates`` updates, in f32 arithmetic as the
        JAX package computes it."""
        if self.ema_decay == self.ema_end_decay:
            return float(np.float32(self.ema_decay))
        frac = np.clip(np.float32(num_updates) / np.float32(self.ema_anneal_end_step),
                       np.float32(0.0), np.float32(1.0))
        return float(np.float32(self.ema_decay)
                     + frac * (np.float32(self.ema_end_decay) - np.float32(self.ema_decay)))

    @torch.no_grad()
    def step(self, ema: nn.Module, new: nn.Module, num_updates: int) -> None:
        """One update of ``ema``'s parameters towards ``new``'s, which have
        the same names, in place."""
        decay = np.float32(self.get_annealed_rate(num_updates))
        averaged, sources = [], []
        new_params = dict(new.named_parameters())
        for name, p in ema.named_parameters():
            p, src = _local(p), _local(new_params[name])
            if any(s in name for s in self.skip_keys):
                p.copy_(src)
            else:
                averaged.append(p)
                sources.append(src.to(p.dtype))
        if averaged:
            torch._foreach_mul_(averaged, float(decay))
            torch._foreach_add_(averaged, sources, alpha=float(np.float32(1.0) - decay))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if hasattr(t, "to_local") else t
