"""Normalization layers.

Counterpart of :mod:`mmlearn_tpu.modules.layers.normalization`.
:class:`FusedLayerNorm` backs the transformer blocks and always runs kernel
K2 on a CUDA tensor (the JAX package leaves its TPU kernel opt-in; on the
H100 the hand-written kernel is the default). :class:`LayerNorm` is the
counterpart of flax ``nn.LayerNorm`` and stays plain PyTorch, as the towers'
``norm_pre`` and final ``norm`` are plain in the JAX package too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmlearn_tpu_torch.ops.fused_norm import fused_add_layernorm, fused_layernorm


class AffineNorm(nn.Module):
    """Scale/shift over the last axis, ``weight``/``bias`` in f32."""

    def __init__(
        self,
        dim: int,
        eps: float = 1e-6,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class FusedLayerNorm(AffineNorm):
    """LayerNorm with f32 statistics; optionally folds in a residual add.

    ``forward(x)`` returns ``LN(x)``; ``forward(x, residual)`` returns
    ``(r, LN(r))`` with ``r = x + residual`` computed in the same kernel.
    """

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None):
        x = x.to(self.dtype)
        if residual is None:
            return fused_layernorm(x, self.weight, self.bias, eps=self.eps)
        return fused_add_layernorm(
            x, residual.to(self.dtype), self.weight, self.bias, eps=self.eps
        )


class LayerNorm(AffineNorm):
    """flax ``nn.LayerNorm``: statistics and affine in f32, output in
    ``dtype``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)
