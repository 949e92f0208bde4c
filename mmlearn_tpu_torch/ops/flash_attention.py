"""Blocked online-softmax attention for long sequences, forward and backward
(kernel K3).

Counterpart of :mod:`mmlearn_tpu.ops.flash_attention`. It takes q, k, v as
``(B, H, N, D)`` and an optional ``(B, N_k)`` key-validity mask, and is the
attention of every layer that the fused short-sequence kernel does not take
(:func:`~mmlearn_tpu_torch.ops.fused_attention.supports_fused`). The CUDA
kernels are ``csrc/flash_attention.cu`` (built by
:mod:`mmlearn_tpu_torch._build` at first use): K3f writes the output and the
f32 log-sum-exp of every row; K3b is two kernels, dQ over key tiles and then
dK/dV over query tiles, both driven by the log-sum-exp and ``delta =
rowsum(dO * O)`` (which the JAX package leaves to XLA): the dQ kernel sums it
in f32 from its own rows and writes it for the dK/dV kernel. The kernels read
q, k, v (and dO) through tensor maps of their strided views and write the
output and the gradients through strides, so :func:`flash_attention_qkv`
takes the head-major packed projection ``(B, N, H * 3 * D)`` of an attention
layer as it is and returns the gradient of the packed projection as K3b
writes it, with no copy on either side.

The plain PyTorch versions: :func:`attention_reference`, the math of the JAX
package's ``_attention_xla``; :func:`flash_fwd_reference`, that output with
the log-sum-exp the TPU kernel emits; :func:`flash_bwd_reference`, the math
of its ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``. :func:`flash_attention`
runs through :class:`FlashAttentionFunction`; it takes the plain versions
only for a tensor that lies on the CPU. For a CUDA tensor it launches the
kernels, at every length, or raises; so does :func:`flash_attention_qkv`
through :class:`FlashQKVFunction`.

Two places where the port follows ``_attention_xla`` (the function the JAX
package computes off the TPU) and not the TPU kernel:

- keys past ``N_k`` are left out, not padded: a row whose every key is
  masked averages V over the ``N_k`` keys (the TPU kernel pads keys to its
  tile with a False mask and averages over the padded keys too);
- the backward is the autodiff of the masked softmax on such rows too:
  ``ds`` is zero at masked scores, and ``p = 1 / N_k`` there (the TPU
  kernel's ``exp(s - lse)`` is 1 on such rows, its dQ/dK nonzero).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from mmlearn_tpu_torch import _build
from mmlearn_tpu_torch.ops import attention_flops, report_flops

#: the finite mask value of the JAX package (``DEFAULT_MASK_VALUE``); in f32
#: its bits are 0xff333332, as the CUDA kernels' ``kNeg``. A row whose every
#: key is masked has the log-sum-exp ``NEG + log(N_k)``, which is ``NEG`` in f32
NEG = -0.7 * float(np.finfo(np.float32).max)

#: launches of the CUDA kernels: the forward, the backward's dK/dV kernel and
#: its dQ kernel
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
#: the same launches by head dim: ``{(key of LAUNCHES, D): launches}``
HEAD_DIM_LAUNCHES: dict[tuple[str, int], int] = {}
#: launches of K3f's f32-output instance (bf16 inputs: the ring's hop), also
#: counted in ``LAUNCHES["flash_fwd"]``
F32_OUT_LAUNCHES = {"flash_fwd_f32": 0}

#: the head dims the CUDA kernels take: 32 and 64 in one swizzled span a
#: tile row, 80 and 88 in three spans of 32 columns (the last zero-filled
#: by TMA past D), 128 in four
_KERNEL_HEAD_DIMS = (32, 64, 80, 88, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # batch and heads are grid dimensions


def _visible(mask, n_q: int, n_k: int, causal: bool, device):
    """Where scores are visible, broadcastable to ``(B, H, N_q, N_k)``, or
    ``None`` when nothing is masked. The causal diagonal is offset by ``N_k -
    N_q``, as ``_attention_xla``'s ``tril(..., n_k - n_q)``."""
    visible = None
    if mask is not None:
        visible = mask.bool()[:, None, None, :]
    if causal:
        keep = torch.ones(n_q, n_k, dtype=torch.bool, device=device).tril(n_k - n_q)
        visible = keep if visible is None else visible & keep
    return visible


def _scores(q, k, mask, scale: float, causal: bool):
    """f32 scores ``(B, H, N_q, N_k)`` with masked ones at ``NEG``, and where
    they are visible (``None`` when nothing is masked)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    visible = _visible(mask, q.shape[2], k.shape[2], causal, q.device)
    if visible is not None:
        s = torch.where(visible, s, NEG)
    return s, visible


def attention_reference(q, k, v, mask, scale: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch version: ``_attention_xla`` (without its
    ``MMLEARN_ATTN_LOGITS`` switch). Scores in f32 (the input is widened
    exactly), softmax in f32, ``p`` rounded to v's type before an
    f32-accumulated PV."""
    return flash_fwd_reference(q, k, v, mask, scale, causal)[0]


def flash_fwd_reference(q, k, v, mask, scale: float, causal: bool,
                        out_dtype: Optional[torch.dtype] = None):
    """:func:`attention_reference`'s output, and the f32 log-sum-exp of each
    row's scores ``(B, H, N_q)`` that the TPU kernel emits for its backward.
    ``out_dtype=torch.float32`` leaves the output in f32 (the ring's hop:
    ``_flash_forward_pallas(..., out_dtype=float32)``); the default is q's
    type."""
    s, _ = _scores(q, k, mask, scale, causal)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    p = e / l
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(out_dtype or q.dtype), lse


def flash_bwd_reference(q, k, v, mask, out, lse, dout, scale: float, causal: bool):
    """Plain PyTorch version of the backward: the math of the TPU kernels
    ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``. Recomputes ``p = exp(s -
    lse)`` in f32, ``delta = sum(dout * out)``, ``dv = p^T dout`` with ``p``
    rounded to the input type, ``ds = p (dp - delta) scale`` rounded to the
    input type, ``dq = ds k``, ``dk = ds^T q``. Returns ``(dq, dk, dv)`` in
    the inputs' types.

    ``ds`` is zero where the score was masked, and on a row whose every key
    is masked (``lse`` = ``NEG``) ``p`` is ``1 / N_k`` at every key: exact
    autodiff of the masked softmax, as the JAX package's reference path.
    Where a row sees a key, masked ``p`` is 0 and this is the TPU kernels'
    function.
    """
    s, visible = _scores(q, k, mask, scale, causal)
    lse = lse.float()[..., None]
    p = torch.exp(s - lse)
    if visible is not None:
        # exp(NEG - lse) / N_k: 1 / N_k where lse is NEG, else 0
        p = torch.where(visible, p, torch.exp((NEG - lse) - math.log(k.shape[2])))
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    ds = p * (dp - delta) * scale
    if visible is not None:
        ds = torch.where(visible, ds, 0.0)
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_COMMON_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, h, n_q, n_k, d
    ctypes.c_int, ctypes.c_float, ctypes.c_int,  # dtype, scale, causal
    ctypes.c_void_p,  # stream
]
# q k v mask out lse strides, then the common arguments with out_f32 before the stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + _COMMON_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
# q k v mask dout out lse delta dq dk dv strides
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + _COMMON_ARGTYPES


def _library():
    """``(forward, backward, error string)`` of ``csrc/flash_attention.cu``,
    built and loaded at the first call."""
    lib = _build.load_library("flash_attention")
    fwd, bwd, err = lib.mmlearn_flash_fwd, lib.mmlearn_flash_bwd, lib.mmlearn_flash_error_string
    if fwd.argtypes is None:
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes, bwd.argtypes = _FWD_ARGTYPES, _BWD_ARGTYPES
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return fwd, bwd, err


def _fits(t: torch.Tensor) -> bool:
    """Whether the kernels read (or write) ``t`` in place: unit last stride,
    every row 16-byte aligned (tensor maps and 16-byte vectors)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        (s * t.element_size()) % 16 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it (:func:`_fits`). Any other view is copied;
    strided views that qualify (q, k, v of a packed projection) are read in
    place."""
    if not _fits(t):
        t = t.contiguous()
    if not _fits(t):
        raise ValueError(f"flash attention kernels need 16-byte aligned rows, got strides "
                         f"{t.stride()} at offset {t.data_ptr() % 16}")
    return t


def _strides(*tensors: torch.Tensor):
    """Batch, head and row strides of each operand in elements (0 for a dim
    of size 1), as the C array the kernels take."""
    flat = [s if n > 1 else 0 for t in tensors for s, n in zip(t.stride()[:3], t.shape[:3])]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check_cuda(q, k, v, mask) -> Optional[torch.Tensor]:
    """Raise on what the CUDA kernels do not take; return the mask as a
    contiguous bool tensor."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernels take float32 or bfloat16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, n_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, H, N_k, D) matching q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim {_KERNEL_HEAD_DIMS}, got {d}")
    if n_q == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs at least one query and one key")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if mask is None:
        return None
    if mask.shape != (b, k.shape[2]) or mask.device != q.device:
        raise ValueError(f"mask must be ({b}, {k.shape[2]}) on {q.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    return mask.to(torch.bool).contiguous()


def _check_grid(q) -> None:
    """Batch and heads are grid dimensions. Checked at the launch, on the
    call's own shape, so that a program traced at a symbolic batch keeps
    it free."""
    b, h = q.shape[:2]
    if b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"flash attention kernels' grid limit: batch={b}, heads={h}")


def _count(key: str, head_dim: int) -> None:
    LAUNCHES[key] += 1
    HEAD_DIM_LAUNCHES[key, head_dim] = HEAD_DIM_LAUNCHES.get((key, head_dim), 0) + 1


def _raise_on(error_string, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(err).decode()} ({err})")


def _common(q, k, scale: float, causal: bool):
    b, h, n_q, d = q.shape
    return (b, h, n_q, k.shape[2], d, _DTYPE_CODES[q.dtype], float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)


def _flash_fwd_cuda(q, k, v, mask, scale: float, causal: bool,
                    out_dtype: Optional[torch.dtype] = None):
    """K3f: the output, a ``(B, H, N_q, D)`` view of a ``(B, N_q, H, D)``
    buffer (so a caller that merges the heads reads it with no copy), in q's
    type or in f32 under ``out_dtype=torch.float32`` (the ring's hop), and
    the f32 log-sum-exp ``(B, H, N_q)``."""
    _check_grid(q)
    q, k, v = _layout(q), _layout(k), _layout(v)
    b, h, n_q, d = q.shape
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"K3f writes q's type or float32, not {out_dtype}")
    out = torch.empty(b, n_q, h, d, dtype=out_dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, n_q, dtype=torch.float32, device=q.device)
    fwd, _, error_string = _library()
    *common, stream = _common(q, k, scale, causal)
    with torch.cuda.device(q.device):
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if mask is None else mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  _strides(q, k, v, out), *common, int(out_dtype == torch.float32), stream)
    _raise_on(error_string, err, "flash attention forward")
    _count("flash_fwd", d)
    if out_dtype != q.dtype:
        F32_OUT_LAUNCHES["flash_fwd_f32"] += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, mask, out, lse, dout, scale: float, causal: bool, grads=None):
    """K3b: the dQ kernel (which also writes ``delta``), then the dK/dV
    kernel. They write dq, dk, dv into ``grads`` where it is given (views the
    kernels write in place, such as the three of a packed ``(B, N, H, 3, D)``
    buffer), else into new tensors; returns them."""
    _check_grid(q)
    q, k, v, out = _layout(q), _layout(k), _layout(v), _layout(out)
    dout = _layout(dout.to(q.dtype))
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if grads is None:
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    elif not all(g.shape == t.shape and g.dtype == t.dtype and _fits(g)
                 for g, t in zip(grads, (q, k, v))):
        raise ValueError("flash attention backward writes dq, dk, dv into views shaped as q, "
                         "k, v with 16-byte aligned rows")
    dq, dk, dv = grads
    _, bwd, error_string = _library()
    with torch.cuda.device(q.device):
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if mask is None else mask.data_ptr(), dout.data_ptr(), out.data_ptr(),
                  lse.contiguous().data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), _strides(q, k, v, dout, out, dq, dk, dv),
                  *_common(q, k, scale, causal))
    _raise_on(error_string, err, "flash attention backward")
    _count("flash_bwd_dkv", q.shape[-1])
    _count("flash_bwd_dq", q.shape[-1])
    return dq, dk, dv


def _report(q, k, backward: bool) -> None:
    b, h, n_q, d = q.shape
    report_flops("flash_bwd" if backward else "flash_fwd",
                 attention_flops(b, h, n_q, k.shape[2], d, backward))


def flash_forward(q, k, v, mask, scale: float, causal: bool):
    """The forward by the tensor's device: the plain version on the CPU, K3f
    on the card (reported to the open FLOP counters): ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, mask, scale, causal)
    out, lse = _flash_fwd_cuda(q, k, v, mask, scale, causal)
    _report(q, k, backward=False)
    return out, lse


class FlashAttentionFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX package's ``_flash_attention``: saves q,
    k, v, the mask, the output and the log-sum-exp (``_flash_fwd``), and runs
    the backward kernels (the plain backward on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float, causal: bool):
        out, lse = flash_forward(q, k, v, mask, scale, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.config = (scale, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_bwd_reference(q, k, v, mask, out, lse, dout, *ctx.config)
        else:
            grads = _flash_bwd_cuda(q, k, v, mask, out, lse, dout, *ctx.config)
            _report(q, k, backward=True)
        return (*grads, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head scaled dot-product attention, differentiable in q, k, v.

    Args:
        q, k, v: ``(B, H, N_q, D)``, ``(B, H, N_k, D)``, ``(B, H, N_k, D)``.
        mask: optional ``(B, N_k)`` key-validity mask (True or 1 = attend).
        scale: logit scale; defaults to ``D ** -0.5``.
        causal: apply a causal mask (diagonal offset by ``N_k - N_q``).

    Returns:
        ``(B, H, N_q, D)`` in q's dtype.

    A CPU tensor takes :func:`flash_fwd_reference` (and
    :func:`flash_bwd_reference` for the gradient) at any shape. A CUDA
    tensor launches the kernels at every length; they take float32 or
    bfloat16 and ``D`` in {32, 64, 80, 88, 128} and raise on anything else.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"Expected (B, H, N, D) inputs, got {tuple(q.shape)}")
    if mask is not None and mask.ndim != 2:
        raise ValueError(f"mask must be (batch, kv_seq), got {tuple(mask.shape)}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cuda":
        mask = _check_cuda(q, k, v, mask)
    elif q.device.type == "cpu":
        mask = None if mask is None else mask.bool()
    else:
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    return FlashAttentionFunction.apply(q, k, v, mask, scale, causal)


def split_qkv(qkv: torch.Tensor, num_heads: int):
    """q, k, v ``(B, H, N, D)`` of a head-major packed projection ``(B, N, H *
    3 * D)``: three strided views (row stride ``H * 3 * D``), no copy."""
    b, n, _ = qkv.shape
    return qkv.view(b, n, num_heads, 3, -1).permute(3, 0, 2, 1, 4).unbind(0)


def flash_qkv_forward(qkv, mask, num_heads: int, scale: float, causal: bool):
    """:func:`flash_forward` on the three strided views of a head-major
    packed projection: ``(out, lse)``, the output ``(B, N, H * D)`` with the
    heads merged (on the card a view of the buffer K3f writes). The eager
    route, and the implementations of the registered operator
    ``mmlearn::flash_qkv`` (:mod:`.registered`) that a traced program
    calls."""
    b, n, _ = qkv.shape
    out, lse = flash_forward(*split_qkv(qkv, num_heads), mask, scale, causal)
    return out.transpose(1, 2).reshape(b, n, -1), lse


class FlashQKVFunction(torch.autograd.Function):
    """K3 on the head-major packed projection ``(B, N, H * 3 * D)`` of an
    attention layer, as :class:`~mmlearn_tpu_torch.ops.fused_attention.
    FusedMHAFunction` is for K1. The forward launches K3f on the three strided
    views of qkv and returns ``(B, N, H * D)``, a view of the buffer it
    writes. The backward allocates one ``(B, N, H, 3, D)`` buffer and has K3b
    write dq, dk and dv into its three views: the buffer is the gradient of
    qkv, with no stack and no reshape. On a CPU tensor both run the plain
    versions on the views, and the gradients land in the same layout. Under
    ``torch.export`` the forward is the registered operator."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads: int, scale: float, causal: bool):
        if torch.compiler.is_exporting():
            from mmlearn_tpu_torch.ops import registered

            merged, lse = registered.flash_qkv(qkv, mask, num_heads, scale, causal)
        else:
            merged, lse = flash_qkv_forward(qkv, mask, num_heads, scale, causal)
        b, n, _ = qkv.shape
        # the (B, H, N, D) output the backward reads, a view of the merged one
        ctx.save_for_backward(qkv, mask, merged.view(b, n, num_heads, -1).transpose(1, 2), lse)
        ctx.config = (num_heads, scale, causal)
        return merged

    @staticmethod
    def backward(ctx, dout):
        qkv, mask, out, lse = ctx.saved_tensors
        num_heads, scale, causal = ctx.config
        b, n, three_c = qkv.shape
        q, k, v = split_qkv(qkv, num_heads)
        dout = dout.reshape(b, n, num_heads, -1).transpose(1, 2)
        dqkv = torch.empty(b, n, num_heads, 3, three_c // (3 * num_heads), dtype=qkv.dtype,
                           device=qkv.device)
        grads = dqkv.permute(3, 0, 2, 1, 4).unbind(0)
        if qkv.device.type == "cpu":
            for g, x in zip(grads, flash_bwd_reference(q, k, v, mask, out, lse, dout, scale,
                                                       causal)):
                g.copy_(x)
        else:
            _flash_bwd_cuda(q, k, v, mask, out, lse, dout, scale, causal, grads=grads)
            _report(q, k, backward=True)
        return dqkv.view(b, n, three_c), None, None, None, None


def flash_attention_qkv(
    qkv: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Head-major packed multi-head self-attention on K3, differentiable in
    qkv: the JAX package's flash branch (``attention.py:135-145``: split,
    :func:`flash_attention`, heads merged) as one Function.

    Args:
        qkv: ``(B, N, H * 3 * D)`` projection output, packed head-major.
        mask: optional ``(B, N)`` key-validity mask (True or 1 = attend).
        num_heads: number of heads ``H``.
        scale: logit scale; defaults to ``D ** -0.5``.
        causal: apply a causal mask.

    Returns:
        ``(B, N, H * D)`` in qkv's dtype.

    A CPU tensor takes the plain versions at any shape; a CUDA tensor
    launches the kernels (float32 or bfloat16, ``D`` in {32, 64, 80, 88, 128}) or raises.
    """
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, {num_heads} * 3 * D), got {tuple(qkv.shape)}")
    if mask is not None and mask.ndim != 2:
        raise ValueError(f"mask must be (batch, kv_seq), got {tuple(mask.shape)}")
    d = qkv.shape[-1] // (3 * num_heads)
    scale = d ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cuda":
        mask = _check_cuda(*split_qkv(qkv, num_heads), mask)
    elif qkv.device.type == "cpu":
        mask = None if mask is None else mask.bool()
    else:
        raise ValueError(f"flash_attention_qkv runs on cpu or cuda tensors, got {qkv.device}")
    return FlashQKVFunction.apply(qkv, mask, num_heads, scale, causal)
