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

Split over the mesh's ``model`` axis
(:mod:`~mmlearn_tpu_torch.parallel.tensor_parallel`), ``qkv`` gives each rank
its heads (``H / P`` of them, whole) and every branch runs on those, routed
by :func:`kernel_route`: on the card, K1 where
:func:`~mmlearn_tpu_torch.ops.fused_attention.supports_fused` admits the
local heads and the flash branch otherwise, whatever the JAX ``fused_mha``
plan (:func:`~mmlearn_tpu_torch.ops.fused_attention.shard_plan`) says, since
its ``"xla"`` answers come from the TPU kernel's lane tiling, which binds no
CUDA kernel; on a CPU tensor the materialized route where that plan says
``"xla"`` (counted in ``PLAIN_ROUTE``), what the JAX package computes there.
The ring's heads go over ``model`` as the JAX
``sequence_sharded_attention``'s ``P(batch, model, seq, None)``. ``proj`` is
split row-wise: its partial products are all-reduced over the group and its
bias added once. The attention-dropout mask is drawn for every head and cut
to the rank's, so a dropped-out step is one process's; returned weights are
gathered back to every head.

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
from mmlearn_tpu_torch.ops.fused_attention import (
    NEG,
    PLAIN_ROUTE,
    fused_mha,
    shard_plan,
    supports_fused,
)
from mmlearn_tpu_torch.ops.ring_attention import sequence_sharded_attention
from mmlearn_tpu_torch.parallel.mesh import SEQ_AXIS, peek_global_mesh
from mmlearn_tpu_torch.parallel.tensor_parallel import gather_heads, local_slice


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


def kernel_route(device_type: str, plan, seq: int, heads: int, head_dim: int, n: int) -> str:
    """The route of a layer whose global heads :func:`supports_fused`
    admits, on its ``heads`` local heads, given the sharded ``plan``
    (:func:`shard_plan`) and the mesh's ``seq`` size: on a CPU tensor
    ``"plain"`` (the materialized route) where the plan is ``"xla"`` without
    a ``seq`` axis, as the JAX package computes ``_mha_reference_xla`` there,
    else ``"fused"``; on the card ``"fused"`` (K1) where
    :func:`supports_fused` admits the local heads, else ``"flash"`` (K3)."""
    if device_type == "cpu":
        return "plain" if plan == "xla" and seq == 1 else "fused"
    return "fused" if supports_fused(heads, head_dim, n) else "flash"


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
        #: ``(rank, size)`` in the ``model`` group where ``qkv`` is split on
        #: whole heads (set by ``tensor_parallel.parallelize``)
        self.model_shard: Optional[tuple[int, int]] = None

    def draw_masks(self, x_shape) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The keep-masks of the attention weights ``(B, H, N, N)`` and of the
        output ``(B, N, C)`` for an input of ``x_shape``, from the current
        source (each ``None`` where nothing is dropped), in the JAX module's
        order. Under a head split the weights' mask is cut to the rank's
        heads."""
        b, n, c = x_shape
        attn_keep = draw_keep(self.training, self.attn_drop, (b, self.num_heads, n, n))
        return (local_slice(attn_keep, 1, self.model_shard),
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
        d = c // self.num_heads
        qkv = self.qkv(x)
        heads = qkv.shape[-1] // (3 * d)  # H, or this rank's H / P under a head split
        mesh = peek_global_mesh()
        seq = 1 if mesh is None else mesh.shape.get(SEQ_AXIS, 1)
        weights = None
        ring = None
        if not (return_weights or attn_keep is not None) and attention_mask is None:
            if seq > 1 and n % seq == 0:
                ring = mesh.seq_exchange()
        if ring is not None:
            out = sequence_sharded_attention(*split_qkv(qkv, heads), ring,
                                             scale=self.scale, causal=self.causal)
            out = out.transpose(1, 2).reshape(b, n, heads * d)
        elif return_weights or attn_keep is not None:
            out, weights = materialized_attention(qkv, heads, self.scale, self.causal,
                                                  attention_mask, attn_keep, self.attn_drop)
            if return_weights and heads != self.num_heads:
                weights = gather_heads(weights, 1)
        else:
            route = "flash"
            if supports_fused(self.num_heads, d, n):
                plan = None if mesh is None else shard_plan(self.num_heads, d,
                                                            b * mesh.dp_size, mesh)
                route = kernel_route(qkv.device.type, plan, seq, heads, d, n)
            if route == "plain":
                PLAIN_ROUTE["xla"] += 1
                out, _ = materialized_attention(qkv, heads, self.scale, self.causal,
                                                attention_mask)
            elif route == "fused":
                out = fused_mha(qkv, attention_mask, num_heads=heads, scale=self.scale,
                                causal=self.causal)
            else:
                out = flash_attention_qkv(qkv, attention_mask, num_heads=heads,
                                          scale=self.scale, causal=self.causal)
        out = apply_keep(self.proj(out), proj_keep, self.proj_drop)
        return (out, weights) if return_weights else out
