"""LayerNorm and residual-add + LayerNorm, forward (kernel K2, Triton).

Counterpart of :mod:`mmlearn_tpu.ops.fused_norm`; replaces its Pallas
``_fwd_kernel`` (:126) and ``_fwd_add_kernel`` (:139), launched by
``_fwd_pallas`` (:191). LayerNorm over the last axis with f32 mean and
variance (two passes over the row in registers, as ``_ln_ref``), gamma and
beta applied in f32 and the output cast to the input's dtype. The add
variant computes ``r = x + branch`` in the input dtype, writes it, and
normalises it: one read of each input and one write of each output.

What bounds it on the H100: a row of C <= 8192 values is read once and
written once with a few FLOPs per value, so it is bound by memory bandwidth
and wants no tensor cores, TMA or shared-memory tiling. One program per row,
with a power-of-two block of ``next_pow2(C)`` lanes and a masked tail,
expresses exactly that.

``triton`` is imported, and the kernel built, on the first launch, never at
import: the CPU tests import this module on hosts without triton. The
wrappers take the plain version (:func:`ln_reference`) only for a tensor
that lies on the CPU; for a CUDA tensor they launch the kernel or raise.
"""

# no ``from __future__ import annotations``: Triton reads the kernel's
# ``tl.constexpr`` annotations as objects
import functools
import os
from typing import Tuple

import torch

from mmlearn_tpu_torch import _build

#: launches of the Triton kernel (both variants), counted by the wrappers
LAUNCHES = {"layernorm_fwd": 0}

_MAX_C = 8192
_DTYPES = (torch.float32, torch.bfloat16)


def ln_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain PyTorch version: ``_ln_ref`` of the JAX package."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return (xhat * gamma.float() + beta.float()).to(x.dtype)


@functools.cache
def _kernel():
    global tl  # the kernel body reads ``tl`` as a module global
    os.environ.setdefault(
        "TRITON_CACHE_DIR", os.path.join(os.path.dirname(_build.BUILD_DIR), "triton")
    )
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd_kernel(
        x_ptr, a_ptr, g_ptr, b_ptr, r_ptr, y_ptr, n_cols, eps,
        BLOCK: tl.constexpr, HAS_ADD: tl.constexpr,
    ):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        inside = cols < n_cols
        offs = row * n_cols + cols
        x = tl.load(x_ptr + offs, mask=inside, other=0.0)
        if HAS_ADD:
            x = x + tl.load(a_ptr + offs, mask=inside, other=0.0)
            tl.store(r_ptr + offs, x, mask=inside)
        xf = x.to(tl.float32)
        mean = tl.sum(xf, axis=0) / n_cols
        xc = tl.where(inside, xf - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n_cols
        gamma = tl.load(g_ptr + cols, mask=inside, other=0.0).to(tl.float32)
        beta = tl.load(b_ptr + cols, mask=inside, other=0.0).to(tl.float32)
        y = xc * tl.rsqrt(var + eps) * gamma + beta
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=inside)

    return triton, _ln_fwd_kernel


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"layernorm kernel takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    if not 0 < c <= _MAX_C:
        raise ValueError(f"layernorm kernel takes 0 < C <= {_MAX_C}, got {c}")
    if not x.is_contiguous():
        raise ValueError("layernorm kernel needs a contiguous input")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous ({c},) tensor on {x.device}, got "
                f"{tuple(p.shape)} on {p.device}"
            )


def _launch(x, branch, gamma, beta, r, y, eps: float) -> None:
    triton, kernel = _kernel()
    c = x.shape[-1]
    rows = x.numel() // c
    block = triton.next_power_of_2(c)
    has_add = branch is not None
    with torch.cuda.device(x.device):
        kernel[(rows,)](
            x, branch if has_add else x, gamma, beta, r if has_add else y, y,
            c, float(eps), BLOCK=block, HAS_ADD=has_add,
            num_warps=min(max(block // 256, 1), 16),
        )
    LAUNCHES["layernorm_fwd"] += 1


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on cpu or cuda tensors, got {x.device}")
    return True


def fused_layernorm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics (flax semantics)."""
    if not _on_cuda(x):
        return ln_reference(x, gamma, beta, float(eps))
    _check(x, gamma, beta)
    y = torch.empty_like(x)
    _launch(x, None, gamma, beta, None, y, eps)
    return y


def fused_add_layernorm(
    x: torch.Tensor,
    branch: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + branch; y = LN(r)`` in one pass. Returns ``(r, y)``."""
    if not _on_cuda(x):
        r = x + branch
        return r, ln_reference(r, gamma, beta, float(eps))
    _check(x, gamma, beta)
    if (
        branch.shape != x.shape
        or branch.dtype != x.dtype
        or branch.device != x.device
        or not branch.is_contiguous()
    ):
        raise ValueError(
            f"branch must match x {tuple(x.shape)} {x.dtype} contiguous, got "
            f"{tuple(branch.shape)} {branch.dtype}"
        )
    r = torch.empty_like(x)
    y = torch.empty_like(x)
    _launch(x, branch, gamma, beta, r, y, eps)
    return r, y
