"""Multi-head self-attention, counterpart of
:mod:`mmlearn_tpu.modules.layers.attention`.

The fused ``qkv`` Linear is packed **head-major** (``[h0_q | h0_k | h0_v |
h1_q | ...]``) so kernel K1 reads its output in place, and ``proj`` follows.
This covers the JAX module's fused-kernel branch (``attention.py:128-134``);
on a CPU tensor the same function runs as plain PyTorch at any shape, which
is what the JAX package computes off the TPU. The ring-attention,
``return_weights`` and attention-dropout branches are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.ops.fused_attention import fused_mha


class Attention(nn.Module):
    """Multi-head self-attention with a fused, head-major qkv projection."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        causal: bool = False,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.causal = causal
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, param_dtype)
        self.proj = Dense(dim, dim, True, dtype, param_dtype)

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if attention_mask is not None and attention_mask.ndim != 2:
            raise ValueError(
                "attention_mask must be (batch, kv_seq), got "
                f"{tuple(attention_mask.shape)}"
            )
        out = fused_mha(
            self.qkv(x), attention_mask, num_heads=self.num_heads,
            scale=self.scale, causal=self.causal,
        )
        return self.proj(out)
