"""Multi-head self-attention, counterpart of
:mod:`mmlearn_tpu.modules.layers.attention`.

The fused ``qkv`` Linear is packed **head-major** (``[h0_q | h0_k | h0_v |
h1_q | ...]``) so kernel K1 reads its output in place, and ``proj`` follows.
Routing is the JAX module's:

- under ``return_weights``, or with attention dropout in a train step, the
  materialized route (``attention.py:104-124``): the scores, their softmax
  and both products as plain PyTorch, as XLA computes them there (the
  weights, dropped out, are what it returns);
- else the fused short-sequence kernel where
  :func:`~mmlearn_tpu_torch.ops.fused_attention.supports_fused` admits the
  shape (``attention.py:128-134``), through
  :class:`~mmlearn_tpu_torch.ops.fused_attention.FusedMHAFunction`;
- else the flash branch (``attention.py:135-145``: the head-major qkv split
  into ``(B, H, N, D)`` q, k, v, then flash attention), through
  :class:`~mmlearn_tpu_torch.ops.flash_attention.FlashQKVFunction`, whose
  split is three strided views that the CUDA kernels read in place; the
  kernels write the output with the heads already merged, and the gradient
  of qkv straight into one packed buffer.

- the ring branch (``attention.py:78-108``) under the JAX conditions: no
  mask, no attention dropout, no returned weights, a global mesh with a
  ``seq`` axis of size P > 1 and ``N % P == 0``:
  :func:`~mmlearn_tpu_torch.ops.ring_attention.sequence_sharded_attention`
  over the mesh's ``seq`` exchange (every rank of the group holds the whole
  sequence here, runs its block through the ring and gathers the output).

On a CPU tensor the kernel branches run as plain PyTorch, which is what the
JAX package computes off the TPU. Both projections are ``Int8Dense``, so
``MMLEARN_QUANT`` reaches them as it does in the JAX package. ``proj_drop``
drops the projection's output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.modules.layers.dropout import apply_keep, draw_keep
from mmlearn_tpu_torch.modules.layers.quantization import Int8Dense
from mmlearn_tpu_torch.ops.flash_attention import flash_attention_qkv, split_qkv
from mmlearn_tpu_torch.ops.fused_attention import NEG, fused_mha, supports_fused
from mmlearn_tpu_torch.ops.ring_attention import sequence_sharded_attention
from mmlearn_tpu_torch.parallel.mesh import SEQ_AXIS, peek_global_mesh


def materialized_attention(
    qkv: torch.Tensor,
    num_heads: int,
    scale: float,
    causal: bool,
    attention_mask: Optional[torch.Tensor] = None,
    keep: Optional[torch.Tensor] = None,
    rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX module's materialized route on the head-major packed ``qkv``:
    f32 scores times ``scale``, masked keys and (causal) later keys at
    ``NEG``, the softmax in f32 cast to qkv's type, dropped out where
    ``keep`` is given, then the weights times v in qkv's type. Returns
    ``(out (B, N, H * D), weights (B, H, N, N))``."""
    b, n, _ = qkv.shape
    q, k, v = split_qkv(qkv, num_heads)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if attention_mask is not None:
        s = torch.where(attention_mask.bool()[:, None, None, :], s, NEG)
    if causal:
        s = torch.where(torch.ones(n, n, dtype=torch.bool, device=s.device).tril(), s, NEG)
    weights = apply_keep(torch.softmax(s, dim=-1).to(qkv.dtype), keep, rate)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    return out.transpose(1, 2).reshape(b, n, -1), weights


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
        qk_scale: Optional[float] = None,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
    ) -> None:
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.scale = qk_scale if qk_scale is not None else (dim // num_heads) ** -0.5
        self.causal = causal
        self.attn_drop = float(attn_drop)
        self.proj_drop = float(proj_drop)
        self.qkv = Int8Dense(dim, 3 * dim, qkv_bias, dtype, param_dtype)
        self.proj = Int8Dense(dim, dim, True, dtype, param_dtype)

    def draw_masks(self, x_shape) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The keep-masks of the attention weights ``(B, H, N, N)`` and of the
        output ``(B, N, C)`` for an input of ``x_shape``, from the current
        source (each ``None`` where nothing is dropped), in the JAX module's
        order."""
        b, n, c = x_shape
        return (draw_keep(self.training, self.attn_drop, (b, self.num_heads, n, n)),
                draw_keep(self.training, self.proj_drop, (b, n, c)))

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        keeps: Optional[tuple[Optional[torch.Tensor], Optional[torch.Tensor]]] = None,
        return_weights: bool = False,
    ):
        """``keeps``: the masks :meth:`draw_masks` gives, drawn now where not
        passed. Returns the output, and with ``return_weights`` also the
        attention weights ``(B, H, N, N)``."""
        if attention_mask is not None and attention_mask.ndim != 2:
            raise ValueError(
                "attention_mask must be (batch, kv_seq), got "
                f"{tuple(attention_mask.shape)}"
            )
        attn_keep, proj_keep = self.draw_masks(x.shape) if keeps is None else keeps
        b, n, c = x.shape
        qkv = self.qkv(x)
        weights = None
        ring = None
        if not (return_weights or attn_keep is not None) and attention_mask is None:
            mesh = peek_global_mesh()
            seq = 1 if mesh is None else mesh.shape.get(SEQ_AXIS, 1)
            if seq > 1 and n % seq == 0:
                ring = mesh.seq_exchange()
        if ring is not None:
            out = sequence_sharded_attention(*split_qkv(qkv, self.num_heads), ring,
                                             scale=self.scale, causal=self.causal)
            out = out.transpose(1, 2).reshape(b, n, c)
        elif return_weights or attn_keep is not None:
            out, weights = materialized_attention(qkv, self.num_heads, self.scale, self.causal,
                                                  attention_mask, attn_keep, self.attn_drop)
        elif supports_fused(self.num_heads, c // self.num_heads, n):
            out = fused_mha(qkv, attention_mask, num_heads=self.num_heads,
                            scale=self.scale, causal=self.causal)
        else:
            out = flash_attention_qkv(qkv, attention_mask, num_heads=self.num_heads,
                                      scale=self.scale, causal=self.causal)
        out = apply_keep(self.proj(out), proj_keep, self.proj_drop)
        return (out, weights) if return_weights else out
