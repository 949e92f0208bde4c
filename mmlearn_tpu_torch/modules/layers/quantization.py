"""int8 training modes of the block projections, counterpart of
:mod:`mmlearn_tpu.modules.layers.quantization`.

Dynamic symmetric absmax quantization: activations per row (token),
weights per output channel, an exact s32 product dequantized by ``sx * sw``.
``MMLEARN_QUANT`` picks the mode of every transformer-block projection
(attention ``qkv``/``proj``, MLP ``fc{i}``):

- ``int8_fwd``: int8 forward, exact straight-through backward
  (:func:`int8_matmul_ste`);
- ``int8``: int8 forward, dgrad and wgrad, each with its scales on the
  non-contracted dims (:func:`int8_matmul_full`);
- ``int8_sb``: "switchback": forward and dgrad through kernel K5, the
  quantizing int8 product (the bias added in its epilogue), and an exact
  wgrad (:func:`mmlearn_tpu_torch.ops.int8_matmul.switchback_matmul`);
- unset, or any other value: the plain :class:`Dense` product.

The JAX package reads the variable at every trace; the port reads it at
every call of :class:`Int8Dense`, so one module follows the variable as it
is flipped. ``int8_fwd`` and ``int8`` compute their s8 products outside any
kernel, as the JAX package leaves them to XLA: :func:`exact_int_dot` takes
them in f64, which holds every s32 sum exactly (``|sum| <= 127^2 K <
2^53``). Weights are quantized after the cast to the compute type, as
``Int8Dense`` quantizes after ``promote_dtype``. Parameter names and shapes
are :class:`Dense`'s, so weights cross the bridge unchanged. A mode with the
projections split over the mesh's ``model`` axis raises
``NotImplementedError``: a row split would quantize a share of each row by
scales that are not the whole row's (ROADMAP's queue).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.ops.int8_matmul import (
    _int8_fwd,
    _quantize,
    exact_int_dot,
    switchback_matmul,
)

#: the values of ``MMLEARN_QUANT`` that name a mode
QUANT_MODES = ("int8_fwd", "int8", "int8_sb")


def quant_mode() -> Optional[str]:
    """Active quantization mode, read from ``MMLEARN_QUANT`` now."""
    mode = os.environ.get("MMLEARN_QUANT", "").strip().lower()
    return mode or None


class Int8MatmulSTE(torch.autograd.Function):
    """``int8_matmul_ste``: int8 forward, the exact gradients of ``x @ w.T``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.matmul(g, w).to(x.dtype)
        dw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return dx, dw.to(w.dtype)


class Int8MatmulFull(torch.autograd.Function):
    """``int8_matmul_full``: int8 forward, dgrad and wgrad. Scales sit on
    the non-contracted dims so they factor out of the integer sums:
    dgrad ``g`` per row and ``w`` per input column, wgrad ``g`` and ``x``
    per column."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, n = x.shape[-1], w.shape[0]
        x2, g2 = x.reshape(-1, k), g.reshape(-1, n)
        qg_r, sg_r = _quantize(g2, -1)  # (T, N), (T, 1)
        qw_r, sw_r = _quantize(w, 0)  # (N, K), (1, K)
        dx = (exact_int_dot(qg_r, qw_r) * (sg_r * sw_r)).to(x.dtype)
        qx_c, sx_c = _quantize(x2, 0)  # (T, K), (1, K)
        qg_c, sg_c = _quantize(g2, 0)  # (T, N), (1, N)
        dw = exact_int_dot(qg_c.t(), qx_c) * (sg_c.t() * sx_c)
        return dx.reshape(x.shape), dw.to(w.dtype)


def int8_matmul_ste(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (``w`` as ``(out, in)``), int8 forward, STE backward."""
    return Int8MatmulSTE.apply(x, w)


def int8_matmul_full(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (``w`` as ``(out, in)``), int8 in all three products."""
    return Int8MatmulFull.apply(x, w)


class Int8Dense(Dense):
    """The transformer blocks' projection: :class:`Dense` whose product
    follows ``MMLEARN_QUANT``, read at every call (the JAX package's
    ``dense`` factory and ``Int8Dense``). Unset, or a value other than
    ``int8_fwd``, ``int8`` and ``int8_sb``, computes exactly as
    :class:`Dense`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = quant_mode()
        if mode in QUANT_MODES and hasattr(self.weight, "placements"):
            # a row split would quantize a share of each row, by scales
            # that are not the whole row's: other numbers than the JAX
            # package's
            raise NotImplementedError(
                f"MMLEARN_QUANT={mode} with the projections split over the model axis "
                "(ROADMAP: int8 under model > 1)")
        dt = self.dtype
        x, w = x.to(dt), self.merged_weight().to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if mode == "int8_sb":
            # the bias joins K5's epilogue (a separate add where K5 does not run)
            return switchback_matmul(x, w, bias)
        if mode == "int8":
            y = int8_matmul_full(x, w)
        elif mode == "int8_fwd":
            y = int8_matmul_ste(x, w)
        else:
            return F.linear(x, w, bias)
        return y if bias is None else y + bias
