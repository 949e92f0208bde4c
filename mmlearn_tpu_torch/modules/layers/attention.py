"""Multi-head self-attention, counterpart of
:mod:`mmlearn_tpu.modules.layers.attention`.

The fused ``qkv`` Linear is packed **head-major** (``[h0_q | h0_k | h0_v |
h1_q | ...]``) so kernel K1 reads its output in place, and ``proj`` follows.
This covers the JAX module's two kernel branches, routed as it routes them
by :func:`~mmlearn_tpu_torch.ops.fused_attention.supports_fused`: the fused
short-sequence kernel (``attention.py:128-134``) through
:class:`~mmlearn_tpu_torch.ops.fused_attention.FusedMHAFunction`, and the
flash branch (``attention.py:135-145``: the head-major qkv split into
``(B, H, N, D)`` q, k, v, then flash attention) for every other layer,
through :class:`~mmlearn_tpu_torch.ops.flash_attention.FlashQKVFunction`.
Its split is three strided views that the CUDA kernels read in place; the
kernels write the output with the heads already merged, and the gradient of
qkv straight into one packed buffer. On a CPU tensor both
branches run as plain PyTorch, which is what the JAX package computes off
the TPU. Both projections are ``Int8Dense``, so ``MMLEARN_QUANT`` reaches
them as it does in the JAX package. The ring-attention, ``return_weights``
and attention-dropout branches are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.modules.layers.quantization import Int8Dense
from mmlearn_tpu_torch.ops.flash_attention import flash_attention_qkv
from mmlearn_tpu_torch.ops.fused_attention import fused_mha, supports_fused


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
        self.qkv = Int8Dense(dim, 3 * dim, qkv_bias, dtype, param_dtype)
        self.proj = Int8Dense(dim, dim, True, dtype, param_dtype)

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if attention_mask is not None and attention_mask.ndim != 2:
            raise ValueError(
                "attention_mask must be (batch, kv_seq), got "
                f"{tuple(attention_mask.shape)}"
            )
        b, n, c = x.shape
        qkv = self.qkv(x)
        if supports_fused(self.num_heads, c // self.num_heads, n):
            out = fused_mha(qkv, attention_mask, num_heads=self.num_heads,
                            scale=self.scale, causal=self.causal)
        else:
            out = flash_attention_qkv(qkv, attention_mask, num_heads=self.num_heads,
                                      scale=self.scale, causal=self.causal)
        return self.proj(out)
