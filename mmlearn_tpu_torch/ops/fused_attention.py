"""Fused short-sequence multi-head attention, forward (kernel K1).

Counterpart of :mod:`mmlearn_tpu.ops.fused_attention`. The projection that
feeds it is packed **head-major**, ``(B, N, H * [q|k|v] * D)``, so the kernel
reads the qkv Linear's output in place and writes ``(B, N, H * D)`` with no
transpose. The CUDA kernel is ``csrc/fused_attention.cu`` (built by
:mod:`mmlearn_tpu_torch._build` at first use); its plain PyTorch version is
:func:`mha_reference`, the math of the JAX package's ``_mha_reference_xla``.

:func:`fused_mha` takes the plain version only for a tensor that lies on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from mmlearn_tpu_torch import _build

#: the TPU kernel's finite mask value (``_NEG``): a row whose every key is
#: masked then averages V over all keys instead of producing NaN
NEG = -0.7 * float(np.finfo(np.float32).max)

#: launches of the CUDA kernel, counted by :func:`fused_mha`
LAUNCHES = {"fused_mha_fwd": 0}

_MAX_SEQ = 2048
_KERNEL_HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _permute_qkv(arr, num_heads: int, src: int, dst: int):
    lead = arr.shape[:-1]
    three_c = arr.shape[-1]
    d = three_c // (3 * num_heads)
    split = (3, num_heads, d) if src == -3 else (num_heads, 3, d)
    a = arr.reshape(*lead, *split)
    a = np.moveaxis(a, src, dst) if isinstance(arr, np.ndarray) else a.movedim(src, dst)
    return a.reshape(*lead, three_c)


def interleave_qkv_heads(kernel, num_heads: int):
    """``[Wq | Wk | Wv]`` packing to head-major ``[h0_q | h0_k | h0_v | h1_q
    | ...]`` along the last axis. Takes numpy arrays or tensors of any
    leading shape: an ``(in, 3C)`` kernel, a ``(3C,)`` bias, a stacked
    ``(depth, in, 3C)`` kernel."""
    return _permute_qkv(kernel, num_heads, -3, -2)


def uninterleave_qkv_heads(kernel, num_heads: int):
    """Inverse of :func:`interleave_qkv_heads`."""
    return _permute_qkv(kernel, num_heads, -2, -3)


def _head_group(head_dim: int) -> int:
    """Heads per program of the TPU kernel (lane width a multiple of 128)."""
    width = 3 * head_dim
    return math.lcm(width, 128) // width


def supports_fused(num_heads: int, head_dim: int, seq: int) -> bool:
    """Dispatch predicate of the fused short-sequence kernel.

    The JAX package's predicate is a TPU VMEM byte model; at the shapes of
    this slice its outcome is ``seq <= 2048 and num_heads % head_group ==
    0``, with ``head_group = lcm(3D, 128) / 3D`` (2 heads at D=64, 4 at
    D=32). The port keeps exactly that rule so both packages route the same
    layers to the kernel. The CUDA kernel itself needs ``head_dim`` in
    {32, 64}; :func:`fused_mha` checks that.
    """
    return seq <= _MAX_SEQ and num_heads % _head_group(head_dim) == 0


def mha_reference(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
    causal: bool,
) -> torch.Tensor:
    """Plain PyTorch version: ``_mha_reference_xla`` on the head-major
    packing. Scores in f32 (the input is widened exactly), softmax in f32,
    ``p`` rounded to the input type before an f32-accumulated PV."""
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    x = qkv.reshape(b, n, num_heads, 3, d)
    q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask.bool()[:, None, None, :], s, NEG)
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=qkv.device).tril()
        s = torch.where(keep, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, n, num_heads * d).to(qkv.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("fused_attention")
    fn = lib.mmlearn_fused_mha_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, mask, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, n, h, d
            ctypes.c_int, ctypes.c_float, ctypes.c_int,  # dtype, scale, causal
            ctypes.c_void_p,  # stream
        ]
        lib.mmlearn_cuda_error_string.restype = ctypes.c_char_p
        lib.mmlearn_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _fused_mha_cuda(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
    causal: bool,
) -> torch.Tensor:
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_mha kernel takes float32 or bfloat16, got {qkv.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_mha kernel takes head_dim 32 or 64, got {d}")
    if not supports_fused(num_heads, d, n):
        raise ValueError(
            f"fused_mha kernel does not take heads={num_heads}, head_dim={d}, "
            f"seq={n}: longer sequences need the flash kernel, not yet ported"
        )
    if not qkv.is_contiguous():
        raise ValueError("fused_mha kernel needs a contiguous qkv")
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"fused_mha kernel grid limit: batch={b}, heads={num_heads}")
    if mask is not None:
        if mask.shape != (b, n) or mask.device != qkv.device:
            raise ValueError(
                f"mask must be ({b}, {n}) on {qkv.device}, got "
                f"{tuple(mask.shape)} on {mask.device}"
            )
        mask = mask.to(torch.bool).contiguous()
    out = torch.empty(b, n, num_heads * d, dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.mmlearn_fused_mha_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), b, n, num_heads, d, _DTYPE_CODES[qkv.dtype],
            float(scale), int(causal), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused_mha kernel launch failed: "
            f"{lib.mmlearn_cuda_error_string(err).decode()} ({err})"
        )
    LAUNCHES["fused_mha_fwd"] += 1
    return out


def fused_mha(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Head-major packed multi-head self-attention.

    Args:
        qkv: ``(B, N, H * 3 * D)`` projection output, packed head-major.
        mask: optional ``(B, N)`` key-validity mask (True or 1 = attend).
        num_heads: number of heads ``H``.
        scale: logit scale; defaults to ``D ** -0.5``.
        causal: apply a causal mask.

    Returns:
        ``(B, N, H * D)`` attention output in the input's dtype.

    A CPU tensor takes :func:`mha_reference` at any shape, the function the
    JAX package computes off the TPU. A CUDA tensor launches the kernel,
    which takes float32 or bfloat16, ``D`` in {32, 64} and shapes that
    :func:`supports_fused` admits, and raises on anything else.
    """
    b, n, three_c = qkv.shape
    if three_c % (3 * num_heads):
        raise ValueError(f"qkv dim {three_c} not divisible by 3*{num_heads}")
    d = three_c // (3 * num_heads)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return mha_reference(qkv, mask, num_heads, scale, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha runs on cpu or cuda tensors, got {qkv.device}")
    return _fused_mha_cuda(qkv, mask, num_heads, scale, causal)
