"""Counterpart of flax ``nn.Dense``: parameters kept in ``param_dtype``,
the product computed in ``dtype``.

Flax casts the input, kernel and bias to ``dtype`` before the matmul; with
``dtype=bfloat16`` and ``param_dtype=float32`` (the flagship's mixed
precision) the weights stay f32 and the layer computes in bf16. The weight
is stored the torch way, ``(out, in)``, the transpose of flax's kernel.

A layer that :mod:`mmlearn_tpu_torch.peft` gives LoRA factors computes with
``W0 + delta`` (:meth:`Dense.merged_weight`), the delta recomputed from the
factors at every call; the factors are held outside the layer (they are not
among its parameters, so its ``state_dict`` keys stay those of the base
layer).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal is cut at two standard deviations of the unit
# normal; dividing by this constant restores the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(
    weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal with variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, std=std, a=-2 * std, b=2 * std, generator=generator
        )


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` over ``param_dtype`` parameters."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype)
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax defaults: lecun-normal kernel, zero bias."""
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def merged_weight(self) -> torch.Tensor:
        """The weight the layer computes with: its own, plus the LoRA
        delta where factors are attached, in the parameter dtype."""
        lora = self.__dict__.get("lora")
        return self.weight if lora is None else lora.merge(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.merged_weight().to(dt), bias)
