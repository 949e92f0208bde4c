"""Quantizing int8 matrix product (kernel K5) and the switchback product of
``MMLEARN_QUANT=int8_sb``.

Counterpart of :mod:`mmlearn_tpu.ops.int8_matmul`. :func:`int8_qmm` computes
``x @ (qw * sw).T`` (``+ bias``): each row of ``x`` is absmax-quantized to
int8, multiplied s8 x s8 -> s32 with the weight quantized beforehand, and
dequantized by ``sx * sw``; a bias is added to the product rounded to x's
type, as the separate add it replaces. The weight is kept the torch way,
``(N, K)`` rows with K contiguous (the JAX package's ``qw`` is its ``(K, N)``
transpose). The CUDA kernels are ``csrc/int8_matmul.cu`` (built by
:mod:`mmlearn_tpu_torch._build` at first use), two paths chosen by shape:
where TMA can address the operands (K a multiple of 16, 16-byte aligned
``x`` and ``qw``) a quantize pass and a ``wgmma`` product fed by TMA, one
K5 call counted in ``LAUNCHES["int8_qmm"]``; elsewhere the ``mma.sync``
kernel with byte loads, counted in ``LAUNCHES["int8_qmm_bytes"]``. Their
plain PyTorch version is :func:`int8_qmm_reference`, which keeps every s32
sum exact; both paths equal it bit for bit.

:func:`switchback_matmul` is the JAX package's ``switchback_matmul`` as a
``torch.autograd.Function``: K5 for the forward (``x`` against the weight
quantized per output row, the bias added in its epilogue) and for dgrad
(``g`` against the transposed weight quantized per input column: one
transpose a layer a step), and an exact wgrad ``g.T @ x`` by
``torch.matmul`` in the compute type; the bias gradient is
``g.sum_to_size(bias.shape)``, the call autograd makes for a broadcast add.
Shapes that :func:`supports_int8_qmm` refuses take the composed int8
product and a separate add, as in the JAX package; the routing is decided
before any launch. On a CPU tensor K5 is its plain version; on a CUDA
tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mmlearn_tpu_torch import _build
from mmlearn_tpu_torch.ops import report_flops

#: launches of K5, counted by :func:`int8_qmm` where it launches a path:
#: the TMA path (the quantize pass and the product, one count) and the byte
#: path
LAUNCHES = {"int8_qmm": 0, "int8_qmm_bytes": 0}

#: the JAX package's full-K limit (``_MAX_K``); the kernel holds a block's
#: quantized rows in shared memory and takes the same K
MAX_K = 8192
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    *[ctypes.c_void_p] * 7,  # x, qw, sw, bias, out, qx, sx
    *[ctypes.c_int] * 4,  # m, k, n, dtype
    ctypes.c_void_p,  # stream
]
_BYTES_ARGTYPES = [
    *[ctypes.c_void_p] * 5,  # x, qw, sw, bias, out
    *[ctypes.c_int] * 4,  # m, k, n, dtype
    ctypes.c_void_p,  # stream
]


def _quantize(a: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along ``axis`` (the scale keeps the
    dim). The one quantizer of the port: the composed modes, the weight of
    K5 and K5's plain version all take it.

    The divisor 127 is a tensor filled on ``a``'s device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, one rounding
    off the IEEE quotient that K5 and the JAX package compute, and a tensor
    copied from the host would wait for the card."""
    af = a.float()
    amax = af.abs().amax(dim=axis, keepdim=True).clamp_min(1e-6)
    s = amax / amax.new_full((), 127.0)
    return torch.round(af / s).to(torch.int8), s


def exact_int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two int8 tensors as f32: the exact integer sum (taken in
    f64), rounded to the nearest f32 as an s32 sum converts."""
    return torch.matmul(a.double(), b.double()).float()


def _int8_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with ``x`` quantized per row and the ``(out, in)`` weight
    per output row; in ``x``'s type."""
    qx, sx = _quantize(x, -1)
    qw, sw = _quantize(w, -1)
    return (exact_int_dot(qx, qw.t()) * (sx * sw.t())).to(x.dtype)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization of an ``(N, K)`` weight, each
    output row over the contraction dim: ``(q, scale)`` with scale ``(N,
    1)``. The JAX package's ``quantize_weight(w, axis=0)`` on its ``(K, N)``
    kernel, through the same quantizer as the composed route."""
    return _quantize(w, -1)


def supports_int8_qmm(m: int, k: int, n: int) -> bool:
    """The shapes the JAX package sends to its kernel (full-K blocks)."""
    return k <= MAX_K and m >= 8 and n >= 128


def uses_tma(k: int, x: torch.Tensor, qw: torch.Tensor) -> bool:
    """Whether K5 takes its TMA path: rows TMA can address (a multiple of 16
    bytes of K) and 16-byte aligned operands."""
    return k % 16 == 0 and x.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0


def int8_qmm_reference(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5: the rows of ``x`` quantized in f32, the
    exact s32 sums, ``acc * (sx * sw)`` in f32, rounded to ``x``'s type;
    then ``+ bias`` in ``x``'s type."""
    k, n = x.shape[-1], qw.shape[0]
    qx, sx = _quantize(x.reshape(-1, k), -1)
    y = exact_int_dot(qx, qw.t()) * (sx * sw.reshape(1, n).float())
    y = y.to(x.dtype).reshape(*x.shape[:-1], n)
    return y if bias is None else y + bias


def _library():
    lib = _build.load_library("int8_matmul")
    fn, fn_bytes, err = (lib.mmlearn_int8_qmm, lib.mmlearn_int8_qmm_bytes,
                         lib.mmlearn_int8_error_string)
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
        fn_bytes.restype, fn_bytes.argtypes = ctypes.c_int, _BYTES_ARGTYPES
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return fn, fn_bytes, err


def _int8_qmm_cuda(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    k, n = x.shape[-1], qw.shape[0]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_qmm kernel takes float32 or bfloat16, got {x.dtype}")
    if qw.dtype != torch.int8 or qw.shape != (n, k):
        raise ValueError(f"int8_qmm needs an int8 (N, {k}) weight, got {qw.dtype} "
                         f"{tuple(qw.shape)}")
    if sw.numel() != n:
        raise ValueError(f"int8_qmm needs {n} weight scales, got {tuple(sw.shape)}")
    if bias is not None and (bias.shape != (n,) or bias.dtype != x.dtype):
        raise ValueError(f"int8_qmm needs a ({n},) {x.dtype} bias, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"int8_qmm kernel takes K up to {MAX_K}, got {k}")
    if not (qw.device == sw.device == x.device) or (bias is not None and bias.device != x.device):
        raise ValueError("int8_qmm operands must lie on one device")
    x2 = x.reshape(-1, k).contiguous()
    qw = qw.contiguous()
    sw = sw.reshape(n).to(torch.float32).contiguous()
    bias_ptr = None if bias is None else bias.contiguous().data_ptr()
    m = x2.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    fn, fn_bytes, error_string = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if uses_tma(k, x2, qw):
            qx = torch.empty(m, k, dtype=torch.int8, device=x.device)
            sx = torch.empty(m, dtype=torch.float32, device=x.device)
            err = fn(x2.data_ptr(), qw.data_ptr(), sw.data_ptr(), bias_ptr, out.data_ptr(),
                     qx.data_ptr(), sx.data_ptr(), m, k, n, _DTYPE_CODES[x.dtype], stream)
            path = "int8_qmm"
        else:
            err = fn_bytes(x2.data_ptr(), qw.data_ptr(), sw.data_ptr(), bias_ptr,
                           out.data_ptr(), m, k, n, _DTYPE_CODES[x.dtype], stream)
            path = "int8_qmm_bytes"
    if err != 0:
        raise RuntimeError(
            f"int8_qmm kernel launch failed: {error_string(err).decode()} ({err})")
    LAUNCHES[path] += 1
    return out.reshape(*x.shape[:-1], n)


def int8_qmm(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ (qw * sw).T`` with in-kernel row quantization of ``x``, plus
    ``bias`` where one is given.

    x: ``(..., K)`` f32 or bf16; qw: ``(N, K)`` int8; sw: ``N`` f32 scales
    (``(N, 1)`` as :func:`quantize_weight` gives them, or flat); bias: ``N``
    in ``x``'s type. Returns ``(..., N)`` in ``x``'s type. A CPU tensor takes
    :func:`int8_qmm_reference`; a CUDA tensor launches K5 or raises.
    """
    if x.device.type == "cpu":
        return int8_qmm_reference(x, qw, sw, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_qmm runs on cpu or cuda tensors, got {x.device}")
    return _int8_qmm_cuda(x, qw, sw, bias)


def int8_qmm_forward(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`int8_qmm`, reported to the open FLOP counters where K5 runs
    (the plain version's one product). The eager route, and the
    implementations of the registered operator ``mmlearn::int8_qmm``
    (:mod:`.registered`) that a traced program calls."""
    out = int8_qmm(x, qw, sw, bias)
    if x.device.type != "cpu":
        report_flops("int8_qmm", 2 * math.prod(x.shape[:-1]) * x.shape[-1] * qw.shape[0])
    return out


def _qmm_or_fallback(a: torch.Tensor, qw, sw, b_full: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """K5 where the JAX package runs its kernel (under ``torch.export`` the
    registered operator, so that the program calls K5); the composed int8
    product (the same numbers) and a separate add elsewhere."""
    m, k, n = math.prod(a.shape[:-1]), a.shape[-1], qw.shape[0]
    if supports_int8_qmm(m, k, n):
        if torch.compiler.is_exporting():
            from mmlearn_tpu_torch.ops import registered

            return registered.int8_qmm(a, qw, sw, bias)
        return int8_qmm_forward(a, qw, sw, bias)
    y = _int8_fwd(a, b_full)
    return y if bias is None else y + bias


class SwitchbackMatmul(torch.autograd.Function):
    """``x @ w.T (+ bias)`` (``w`` as ``(out, in)``): int8 forward and dgrad,
    exact wgrad, the bias gradient as autograd takes it for a broadcast add.
    Saves ``x`` and ``w``."""

    @staticmethod
    def forward(ctx, x, w, bias=None):
        ctx.save_for_backward(x, w)
        ctx.bias_shape = None if bias is None else bias.shape
        qw, sw = quantize_weight(w)
        return _qmm_or_fallback(x, qw, sw, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wt = w.t().contiguous()  # (in, out): dgrad's weight, scaled per input column
        qwt, swt = quantize_weight(wt)
        dx = _qmm_or_fallback(g, qwt, swt, wt).to(x.dtype)
        dw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        db = g.sum_to_size(ctx.bias_shape) if ctx.needs_input_grad[2] else None
        return dx, dw.to(w.dtype), db


def switchback_matmul(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w.T (+ bias)``: int8 forward (the bias added in K5's epilogue)
    and int8 dgrad through K5, exact wgrad."""
    return SwitchbackMatmul.apply(x, w, bias)
