"""Fused short-sequence multi-head attention, forward and backward (kernel K1,
and its head-grouped variant for small head dims).

Counterpart of :mod:`mmlearn_tpu.ops.fused_attention`. The projection that
feeds it is packed **head-major**, ``(B, N, H * [q|k|v] * D)``, so the kernel
reads the qkv Linear's output in place and writes ``(B, N, H * D)`` with no
transpose; the backward writes ``dqkv`` in the same packing, so the qkv
Linear's backward reads it with no permute. The CUDA kernels are
``csrc/fused_attention.cu`` (built by :mod:`mmlearn_tpu_torch._build` at first
use): in bf16 on tensor cores, with each head's operands whole in shared
memory, in f32 scalar; the head-grouped ``csrc/fused_attention_packed.cu``
computes the same bits in bf16 with K1's arithmetic (``csrc/k1_arithmetic.cuh``)
and persistent blocks that load the next head while one computes. Their
plain PyTorch versions are :func:`mha_reference`,
the math of the JAX package's ``_mha_reference_xla``, and
:func:`mha_bwd_reference`, the math of its ``_bwd_kernel``; the bf16
backward computes p and ds bit for bit as the latter does on the card.

:func:`fused_mha` runs through :class:`FusedMHAFunction`, which saves ``qkv``,
the output and the mask (no log-sum-exp, as the TPU kernel) and recomputes the
softmax in the backward. It takes the plain versions only for a tensor that
lies on the CPU. For a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import numpy as np
import torch

from mmlearn_tpu_torch import _build
from mmlearn_tpu_torch.ops import attention_flops, report_flops

#: the TPU kernel's finite mask value (``_NEG``): a row whose every key is
#: masked then averages V over all keys instead of producing NaN
NEG = -0.7 * float(np.finfo(np.float32).max)

#: launches of the CUDA kernels: K1's forward by :func:`fused_mha`; K1's
#: backward's two by :class:`FusedMHAFunction` (bf16: p and ds, then the
#: three products; f32: dQ, then dK/dV); the same for the head-grouped
#: kernels K1f-p and K1b-p
LAUNCHES = {"fused_mha_fwd": 0, "fused_mha_bwd": 0, "fused_mha_packed_fwd": 0,
            "fused_mha_packed_bwd": 0}
#: the same launches by head dim: ``{(key of LAUNCHES, D): launches}``
HEAD_DIM_LAUNCHES: dict[tuple[str, int], int] = {}

_MAX_SEQ = 2048
#: the head dims the CUDA kernels take: the towers' 32 and 64, ``vit_huge``'s
#: 80 and ``vit_giant``'s 88 (zero-padded to 96 in shared memory)
_KERNEL_HEAD_DIMS = (32, 64, 80, 88)
#: the JAX package's routing rule between this kernel and the flash kernel:
#: its byte model of the TPU backward's scoped memory (``_bwd_unit_bytes``,
#: ``_BWD_VMEM_LIMIT``), kept here so both packages route the same layers.
#: It is a property of the TPU build, not of the H100 or of this kernel.
_LANES = 128
_BWD_VMEM_LIMIT = 20 * 1024 * 1024
#: the longest sequence the JAX package sends to its packed kernel at each
#: head dim (``_packed_enabled``: past it the TPU kernel's scoped-memory
#: model falls back to the per-head kernel); the port routes the same layers
_PACKED_MAX_SEQ = {16: 360, 32: 512, 64: 768}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may use on the H100 (227 KB)
_SMEM_PER_BLOCK = 232_448
#: head buffers of K1f-p's ring at most (``kMaxStages``)
_PACKED_MAX_STAGES = 8


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


def _pad_to8(n: int) -> int:
    return ((n + 7) // 8) * 8


def _bwd_unit_bytes(seq: int, head_dim: int) -> int:
    """The JAX package's estimate of the TPU backward's scoped memory per
    (sample, head): three f32 ``(N, N)`` temporaries and six f32 ``(N, D)``
    rows, padded to the TPU's (8, 128) tiles."""
    sub = _pad_to8(seq)
    lane = ((seq + _LANES - 1) // _LANES) * _LANES
    dlane = max(((head_dim + _LANES - 1) // _LANES) * _LANES, _LANES)
    return (3 * sub * lane + 6 * sub * dlane) * 4


def supports_fused(num_heads: int, head_dim: int, seq: int) -> bool:
    """Dispatch predicate of the fused short-sequence kernel: the JAX
    package's ``supports_fused``, outcome for outcome. ``seq <= 2048``, heads
    a multiple of ``head_group = lcm(3D, 128) / 3D`` (2 at D=64, 4 at D=32),
    and one head group's backward within the TPU's 20 MiB byte model: that
    admits N <= 768 at D=64, N <= 512 at D=32, N <= 336 at D=80 (8 heads a
    group) and N <= 208 at D=88 (16 a group). Every other layer takes the
    flash kernel (:mod:`mmlearn_tpu_torch.ops.flash_attention`). The CUDA
    kernel itself needs ``head_dim`` in {32, 64, 80, 88}; :func:`fused_mha`
    checks that.
    """
    if seq > _MAX_SEQ:
        return False
    group = _head_group(head_dim)
    if num_heads % group:
        return False
    return group * _bwd_unit_bytes(seq, head_dim) <= _BWD_VMEM_LIMIT


def use_packed(num_heads: int, head_dim: int, seq: int) -> bool:
    """Whether a CUDA tensor of this shape goes to the head-grouped kernels.

    Mirrors the JAX package's ``_packed_enabled`` and its head grouping:
    ``MMLEARN_FUSED_ATTN_PACKED=1`` (read now, at call time), ``head_dim <=
    64`` with ``128 % head_dim == 0``, ``num_heads`` a multiple of the group
    ``128 / head_dim``, and ``seq`` no longer than the JAX package packs at
    that head dim. The kernels take ``head_dim`` 32 or 64 and raise on 16.
    """
    if os.environ.get("MMLEARN_FUSED_ATTN_PACKED", "0") != "1":
        return False
    if not (head_dim <= 64 and 128 % head_dim == 0):
        return False
    return num_heads % (128 // head_dim) == 0 and seq <= _PACKED_MAX_SEQ.get(head_dim, 0)


def packed_fwd_plan(seq: int, head_dim: int) -> tuple[int, int]:
    """``(warps, stages)`` of a K1f-p block (bf16) at this length.

    The block holds a ring of ``stages`` head buffers, each the head's K and V
    rows (``seq`` rounded up to 32, ``[k | v | 8 pad]`` bf16) and its key
    flags, and each warp's 16-row Q strip, the buffers' barriers, counters
    and tags and the block's item counter
    (``slot_bytes`` and ``fwd_fixed_bytes`` in ``csrc/fused_attention_packed.cu``).
    Warps by K1f's instance: 16 for whole rows of up to 128 keys at D=32, 12
    for the other whole-row instances (up to 224 keys), 8 past them; as many
    buffers as fit 227 KB, at most 8. At D=64 one buffer is left past 384
    keys, so the next head no longer loads while one computes.
    """
    rows = -(-seq // 32) * 32
    warps = (16 if head_dim == 32 and rows <= 128 else 12) if rows <= 224 else 8
    slot = rows * (2 * (2 * head_dim + 8) + 1)
    fixed = warps * 16 * (head_dim + 8) * 2 + _PACKED_MAX_STAGES * 16 + 16
    return warps, min(_PACKED_MAX_STAGES, (_SMEM_PER_BLOCK - fixed) // slot)


def _bwd_scratch(batch: int, seq: int, num_heads: int, dtype) -> tuple[int, torch.dtype]:
    """``(numel, dtype)`` of the backward's scratch, K1's and K1b-p's alike:
    in bf16 the p and ds planes, ``(2, B, H, nq, nq)`` query-major with nq =
    ``seq`` rounded up to 16; in f32 each row's max, sum and delta, ``(3, B,
    H, N)``."""
    if dtype == torch.bfloat16:
        nq = -(-seq // 16) * 16
        return 2 * batch * num_heads * nq * nq, torch.bfloat16
    return 3 * batch * num_heads * seq, torch.float32


def _scores(qkv, mask, num_heads: int, scale: float, causal: bool):
    """q, k, v as ``(B, N, H, D)`` views, the f32 scores ``(B, H, N, N)``
    with masked ones at ``NEG``, and where the scores are visible (or
    ``None`` when nothing is masked). Shared by both plain versions, so the
    backward recomputes exactly the forward's softmax."""
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    x = qkv.reshape(b, n, num_heads, 3, d)
    q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    visible = None
    if mask is not None:
        visible = mask.bool()[:, None, None, :]
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=qkv.device).tril()
        visible = keep if visible is None else visible & keep
    if visible is not None:
        s = torch.where(visible, s, NEG)
    return q, k, v, s, visible


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
    b, n, _ = qkv.shape
    _, _, v, s, _ = _scores(qkv, mask, num_heads, scale, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, n, -1).to(qkv.dtype)


def mha_bwd_reference(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor],
    out: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    scale: float,
    causal: bool,
) -> torch.Tensor:
    """Plain PyTorch version of the backward: the math of the TPU kernel's
    ``_bwd_kernel``. Recomputes ``p`` in f32, ``delta = sum(dout * out)``,
    ``dv = p^T dout`` with ``p`` rounded to the input type, ``ds = p (dp -
    delta) scale`` rounded to the input type, ``dq = ds k``, ``dk = ds^T q``;
    returns ``dqkv`` head-major, in qkv's dtype.

    ``ds`` is zero where the score was masked: exact autodiff of the masked
    softmax, as the JAX package's reference path. The TPU kernel differs only
    on rows whose every key is masked, where its ``dq``/``dk`` are not zero.
    """
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    q, k, v, s, visible = _scores(qkv, mask, num_heads, scale, causal)
    p = torch.softmax(s, dim=-1)
    do = dout.reshape(b, n, num_heads, d).float()
    o = out.reshape(b, n, num_heads, d).float()
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, N, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(qkv.dtype).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta) * scale
    if visible is not None:
        ds = torch.where(visible, ds, 0.0)
    ds = ds.to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return torch.stack([dq, dk, dv], dim=3).reshape(b, n, three_c).to(qkv.dtype)


_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, mask, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, n, h, d
    ctypes.c_int, ctypes.c_float, ctypes.c_int,  # dtype, scale, causal
    ctypes.c_void_p,  # stream
]
#: K1f-p's forward takes the ring's head buffers (``stages``) before the stream
_PACKED_FWD_ARGTYPES = [*_FWD_ARGTYPES[:-1], ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, mask, out
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dout, dqkv, stats
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, n, h, d
    ctypes.c_int, ctypes.c_float, ctypes.c_int,  # dtype, scale, causal
    ctypes.c_void_p,  # stream
]
#: per kernel family: its source ``csrc/<name>.cu``, its forward, backward
#: and error-string entry points, and the prefix of its ``LAUNCHES`` keys
_SOURCES = {
    False: ("fused_attention", "mmlearn_fused_mha_fwd", "mmlearn_fused_mha_bwd",
            "mmlearn_cuda_error_string", "fused_mha"),
    True: ("fused_attention_packed", "mmlearn_fused_mha_packed_fwd",
           "mmlearn_fused_mha_packed_bwd", "mmlearn_packed_error_string", "fused_mha_packed"),
}


def _library(packed: bool = False):
    """``(forward, backward, error string, launch-count prefix)`` of K1's
    library or, with ``packed``, of the head-grouped kernels' (built and
    loaded at the first call)."""
    name, fwd_name, bwd_name, err_name, prefix = _SOURCES[packed]
    lib = _build.load_library(name)
    fwd, bwd, err = getattr(lib, fwd_name), getattr(lib, bwd_name), getattr(lib, err_name)
    if fwd.argtypes is None:
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = _PACKED_FWD_ARGTYPES if packed else _FWD_ARGTYPES
        bwd.argtypes = _BWD_ARGTYPES
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return fwd, bwd, err, prefix


def _check_cuda(
    qkv: torch.Tensor, mask: Optional[torch.Tensor], num_heads: int
) -> Optional[torch.Tensor]:
    """Raise on what the CUDA kernels do not take; return the mask as a
    contiguous bool tensor."""
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_mha kernel takes float32 or bfloat16, got {qkv.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_mha kernel takes head_dim {_KERNEL_HEAD_DIMS}, got {d}")
    if not supports_fused(num_heads, d, n):
        raise ValueError(
            f"fused_mha kernel does not take heads={num_heads}, head_dim={d}, "
            f"seq={n}: supports_fused routes such layers to flash_attention"
        )
    if not qkv.is_contiguous():
        raise ValueError("fused_mha kernel needs a contiguous qkv")
    if mask is None:
        return None
    if mask.shape != (b, n) or mask.device != qkv.device:
        raise ValueError(
            f"mask must be ({b}, {n}) on {qkv.device}, got "
            f"{tuple(mask.shape)} on {mask.device}"
        )
    return mask.to(torch.bool).contiguous()


def _count(key: str, head_dim: int, launches: int) -> None:
    LAUNCHES[key] += launches
    HEAD_DIM_LAUNCHES[key, head_dim] = HEAD_DIM_LAUNCHES.get((key, head_dim), 0) + launches


def _raise_on(error_string, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {error_string(err).decode()} ({err})"
        )


def _check_grid(b: int, num_heads: int) -> None:
    """Batch and heads are grid dimensions. Checked at the launch, on the
    call's own shape, so that a program traced at a symbolic batch keeps
    it free."""
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"fused_mha kernel grid limit: batch={b}, heads={num_heads}")


def _check_aligned(*tensors: torch.Tensor) -> None:
    """K1's bf16 kernels copy qkv's (and dout's) rows, and the head-grouped
    kernels every operand, as 16-byte vectors."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("fused_mha kernels need 16-byte aligned tensors")


def _fused_mha_cuda(
    qkv, mask, num_heads: int, scale: float, causal: bool, packed: bool = False
) -> torch.Tensor:
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    _check_grid(b, num_heads)
    out = torch.empty(b, n, num_heads * d, dtype=qkv.dtype, device=qkv.device)
    fwd, _, error_string, prefix = _library(packed)
    if packed or qkv.dtype == torch.bfloat16:
        _check_aligned(qkv)
    # K1f-p's ring of head buffers (its f32 route takes none)
    plan = (packed_fwd_plan(n, d)[1],) if packed else ()
    with torch.cuda.device(qkv.device):
        err = fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), b, n, num_heads, d, _DTYPE_CODES[qkv.dtype],
            float(scale), int(causal), *plan, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(error_string, err, prefix)
    _count(f"{prefix}_fwd", d, 1)
    return out


def _fused_mha_bwd_cuda(
    qkv, mask, out, dout, num_heads: int, scale: float, causal: bool, packed: bool = False
) -> torch.Tensor:
    b, n, three_c = qkv.shape
    d = three_c // (3 * num_heads)
    _check_grid(b, num_heads)
    dout = dout.to(qkv.dtype).contiguous()
    if packed:
        _check_aligned(qkv, out, dout)
    elif qkv.dtype == torch.bfloat16:
        _check_aligned(qkv, dout)
    dqkv = torch.empty_like(qkv)
    numel, scratch_dtype = _bwd_scratch(b, n, num_heads, qkv.dtype)
    scratch = torch.empty(numel, dtype=scratch_dtype, device=qkv.device)
    _, bwd, error_string, prefix = _library(packed)
    with torch.cuda.device(qkv.device):
        err = bwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), scratch.data_ptr(),
            b, n, num_heads, d, _DTYPE_CODES[qkv.dtype], float(scale), int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(error_string, err, f"{prefix} backward")
    _count(f"{prefix}_bwd", d, 2)
    return dqkv


def _report(qkv, num_heads: int, packed: bool, backward: bool) -> None:
    b, n, three_c = qkv.shape
    report_flops(f"{_SOURCES[packed][4]}_{'bwd' if backward else 'fwd'}",
                 attention_flops(b, num_heads, n, n, three_c // (3 * num_heads), backward))


def fused_mha_forward(qkv, mask, num_heads: int, scale: float, causal: bool,
                      packed: bool = False) -> torch.Tensor:
    """The forward by the tensor's device: the plain version on the CPU; on
    the card K1f (or K1f-p under ``packed``), reported to the open FLOP
    counters. The eager route, and the implementations of the registered
    operator ``mmlearn::fused_mha`` (:mod:`.registered`) that a traced
    program calls."""
    if qkv.device.type == "cpu":
        return mha_reference(qkv, mask, num_heads, scale, causal)
    out = _fused_mha_cuda(qkv, mask, num_heads, scale, causal, packed)
    _report(qkv, num_heads, packed, backward=False)
    return out


class FusedMHAFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX package's ``_fused_mha_nomask`` /
    ``_fused_mha_masked``: saves qkv, the mask and the output, and runs the
    backward kernel (the plain backward on a CPU tensor). ``packed`` picks
    the head-grouped kernels for both passes on a CUDA tensor. Under
    ``torch.export`` the forward is the registered operator, so that the
    program calls the kernel and not its plain version."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads: int, scale: float, causal: bool,
                packed: bool = False):
        if torch.compiler.is_exporting():
            from mmlearn_tpu_torch.ops import registered

            out = registered.fused_mha(qkv, mask, num_heads, scale, causal, packed)
        else:
            out = fused_mha_forward(qkv, mask, num_heads, scale, causal, packed)
        ctx.save_for_backward(qkv, mask, out)
        ctx.config = (num_heads, scale, causal)
        ctx.packed = packed
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, mask, out = ctx.saved_tensors
        if qkv.device.type == "cpu":
            dqkv = mha_bwd_reference(qkv, mask, out, dout, *ctx.config)
        else:
            dqkv = _fused_mha_bwd_cuda(qkv, mask, out, dout, *ctx.config, ctx.packed)
            _report(qkv, ctx.config[0], ctx.packed, backward=True)
        return dqkv, None, None, None, None, None


def fused_mha(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Head-major packed multi-head self-attention, differentiable in qkv.

    Args:
        qkv: ``(B, N, H * 3 * D)`` projection output, packed head-major.
        mask: optional ``(B, N)`` key-validity mask (True or 1 = attend).
        num_heads: number of heads ``H``.
        scale: logit scale; defaults to ``D ** -0.5``.
        causal: apply a causal mask.

    Returns:
        ``(B, N, H * D)`` attention output in the input's dtype.

    A CPU tensor takes :func:`mha_reference` (and :func:`mha_bwd_reference`
    for the gradient) at any shape, the function the JAX package computes
    off the TPU. A CUDA tensor launches the kernels, which take float32 or
    bfloat16, ``D`` in {32, 64, 80, 88} and shapes that :func:`supports_fused`
    admits, and raises on anything else: K1's, or the head-grouped ones
    where :func:`use_packed` says so.
    """
    b, n, three_c = qkv.shape
    if three_c % (3 * num_heads):
        raise ValueError(f"qkv dim {three_c} not divisible by 3*{num_heads}")
    d = three_c // (3 * num_heads)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    packed = False
    if qkv.device.type == "cuda":
        mask = _check_cuda(qkv, mask, num_heads)
        packed = use_packed(num_heads, d, n)
    elif qkv.device.type != "cpu":
        raise ValueError(f"fused_mha runs on cpu or cuda tensors, got {qkv.device}")
    return FusedMHAFunction.apply(qkv, mask, num_heads, scale, causal, packed)


#: attention layers that took the plain route because :func:`shard_plan`
#: said ``"xla"`` (the materialized scores on the rank's heads, no kernel;
#: CPU tensors only)
PLAIN_ROUTE = {"xla": 0}


def shard_plan(num_heads: int, head_dim: int, b: int, mesh) -> Optional[int | str]:
    """The JAX ``_shard_map_plan``, outcome for outcome, on the port's mesh
    (:class:`~mmlearn_tpu_torch.parallel.mesh.Mesh`): ``None`` off a mesh
    (``None``, or one device); ``"xla"`` where a ``seq`` axis is over 1, the
    global batch ``b`` does not divide over ``data x fsdp``, ``model`` does
    not divide ``num_heads``, or the local heads do not tile the TPU
    kernel's head group; else the local head count ``num_heads / model``.

    Where the JAX package computes ``_mha_reference_xla`` (``"xla"``) the
    attention layer takes, on a CPU tensor, the plain route,
    ``materialized_attention`` without weights, on the heads its rank holds,
    and counts it in :data:`PLAIN_ROUTE`; on the card it runs those heads on
    the kernels, K1 where :func:`supports_fused` admits them and K3 else
    (``attention.kernel_route``). Under a ``seq`` axis the port keeps the routing of
    its sequence-parallel slice: the same function on K1 for the layers the
    ring does not take (a key mask), as there is no XLA to hand them to."""
    if mesh is None or mesh.size <= 1:
        return None
    if any(size > 1 for axis, size in mesh.shape.items()
           if axis not in ("data", "fsdp", "model")):
        return "xla"
    shards = mesh.shape["data"] * mesh.shape["fsdp"]
    if b % shards:
        return "xla"
    model = mesh.shape.get("model", 1)
    if num_heads % model:
        return "xla"
    local = num_heads // model
    if local % _head_group(head_dim):
        return "xla"
    return local
