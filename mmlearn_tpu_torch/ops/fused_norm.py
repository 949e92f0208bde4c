"""LayerNorm and residual-add + LayerNorm, forward and backward (kernel K2:
the forward K2f and the backward K2b, both CUDA C++ for sm_90a).

Counterpart of :mod:`mmlearn_tpu.ops.fused_norm`; replaces its Pallas
``_fwd_kernel`` (:126) and ``_fwd_add_kernel`` (:139), launched by
``_fwd_pallas`` (:191), and ``_bwd_kernel`` (:144) and ``_bwd_add_kernel``
(:177), launched by ``_bwd_pallas`` (:227).

Forward (``csrc/layernorm_fwd.cu``): LayerNorm over the last axis with f32
mean and variance (two passes over the row in registers, as ``_ln_ref``),
gamma and beta applied in f32 and the output rounded once to the input's
dtype. The add variant computes ``r = x + branch`` rounded to the input
dtype, writes it, and normalises the rounded ``r``: one read of each input
and one write of each output. For C a multiple of 8 with 128 < C <= 2048,
one warp a row in 16-byte vectors, blocks of four warps over consecutive
rows, computing the bits of the kernel it replaced (the port's first K2f,
in Triton: its order of sums and its operations); other widths on a kernel
of one 512-thread block a row (:func:`fwd_route` mirrors the choice).

Backward (``csrc/layernorm_bwd.cu``): per row, mean and rstd recomputed in
f32 from the saved input, ``dxhat = dy * gamma``, ``dx = rstd (dxhat -
mean(dxhat) - xhat mean(dxhat xhat))`` (plus the residual's cotangent in the
add variant), cast to the input's dtype. The TPU kernel sums dgamma/dbeta
across its grid steps in one output block, which works only because that
grid runs in order. On the H100 the blocks run in parallel and in no order:
each keeps its columns' partial sums and writes them to a scratch, and the
blocks that finish last add them up in a fixed order (by groups of blocks,
then the groups) -- one launch, no atomics on the values, the same bits on
every run.

Both are bound by memory bandwidth: a row of C <= 8192 values is read once
and written once with a few FLOPs per value. Both are built by
:mod:`mmlearn_tpu_torch._build` at their first launch, never at import, and
called through ctypes on the current stream; a failed build, plan or launch
raises. The wrappers take the plain versions (:func:`ln_reference`,
:func:`ln_bwd_reference`) only for a tensor that lies on the CPU; for a CUDA
tensor they launch the kernels or raise. :func:`fused_layernorm` and
:func:`fused_add_layernorm` are differentiable through
:class:`LayerNormFunction` and :class:`AddLayerNormFunction`.
"""

import ctypes
from typing import Optional, Tuple

import torch

from mmlearn_tpu_torch import _build
from mmlearn_tpu_torch.ops import report_flops

#: launches of the kernels (both variants), one count each: the forward by
#: the wrappers, the backward by the autograd Functions
LAUNCHES = {"layernorm_fwd": 0, "layernorm_bwd": 0}

#: what K2 reports to a FLOP counter: ``FlopCounterMode`` counts products
#: only, and neither plain version has one
LAYERNORM_FLOPS = 0

_MAX_C = 8192
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ln_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain PyTorch version: ``_ln_ref`` of the JAX package."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return (xhat * gamma.float() + beta.float()).to(x.dtype)


def ln_bwd_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    dy: torch.Tensor,
    eps: float,
    dr: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``_ln_bwd_ref`` of the JAX
    package. Returns ``dx`` in x's dtype (with ``dr``, the residual's
    cotangent, added in f32 before the cast, as the TPU add kernel does)
    and f32 ``dgamma``, ``dbeta`` summed over every row."""
    xf = x.float()
    dyf = dy.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mu) * rstd
    dxhat = dyf * gamma.float()
    c1 = dxhat.mean(dim=-1, keepdim=True)
    c2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - c1 - xhat * c2)
    if dr is not None:
        dx = dx + dr.float()
    c = x.shape[-1]
    dgamma = (dyf * xhat).reshape(-1, c).sum(0)
    dbeta = dyf.reshape(-1, c).sum(0)
    return dx.to(x.dtype), dgamma, dbeta


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
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


_FWD_ARGTYPES = [
    *[ctypes.c_void_p] * 6,  # x, branch, gamma, beta, r, y
    *[ctypes.c_int] * 5,  # rows, c, dtype, align, blocks
    ctypes.c_float,  # eps
    ctypes.c_void_p,  # stream
]
#: the forward's blocks, by (device, rows, c, dtype code, add, alignment)
_FWD_PLANS: dict = {}
#: the rows kernel's widest row: eight 256-value vectors a warp
_ROWS_MAX_C = 2048


def fwd_route(c: int, dtype: torch.dtype, align: int) -> Tuple[int, int]:
    """The forward's kernel for rows of ``c`` values of ``dtype`` whose row
    pointers are ``align``-byte aligned, as ``csrc/layernorm_fwd.cu``'s
    plan picks it: ``(bytes an access, vectors of eight a lane)`` of the
    rows kernel (16-byte accesses where the rows are aligned to them, else
    value by value; ``next_pow2(c) / 256`` vectors, the last ones masked),
    or ``(0, 0)`` for the wide kernel: ``c`` a multiple of 8 with 128 < c <=
    2048."""
    if c % 8 or not 128 < c <= _ROWS_MAX_C:
        return 0, 0
    return (16 if align >= 16 else dtype.itemsize), (1 << (c - 1).bit_length()) // 256


def _fwd_library():
    lib = _build.load_library("layernorm_fwd")
    fn, plan, err = lib.mmlearn_ln_fwd, lib.mmlearn_ln_fwd_plan, lib.mmlearn_ln_fwd_error_string
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _FWD_ARGTYPES
        plan.restype = ctypes.c_int
        plan.argtypes = [*[ctypes.c_int] * 5, *[ctypes.POINTER(ctypes.c_int)] * 3]
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return fn, plan, err


def fwd_plan(rows: int, c: int, dtype: torch.dtype, has_add: bool, align: int
             ) -> Tuple[int, int, int]:
    """``mmlearn_ln_fwd_plan`` on the current device: ``(bytes an access,
    vectors a lane, blocks)``; raises where it has no launch."""
    _, plan, error_string = _fwd_library()
    nbytes, nv, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = plan(rows, c, _DTYPE_CODES[dtype], int(has_add), align, ctypes.byref(nbytes),
               ctypes.byref(nv), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"layernorm forward has no launch for rows={rows} C={c}: "
                           f"{error_string(err).decode()} ({err})")
    return nbytes.value, nv.value, blocks.value


def _launch(x, branch, gamma, beta, r, y, eps: float) -> None:
    """The forward kernel on CUDA tensors, one launch: ``y`` (and ``r``)
    written in place."""
    c = x.shape[-1]
    rows = x.numel() // c
    code = _DTYPE_CODES[x.dtype]
    align = _alignment(x, branch, r, y)
    fn, _, error_string = _fwd_library()
    # the kernel reads gamma and beta as 16-byte vectors
    g32, b32 = (p if p.data_ptr() % 16 == 0 else p.clone()
                for p in (gamma.float(), beta.float()))
    with torch.cuda.device(x.device):
        key = (x.device.index, rows, c, code, branch is not None, align)
        blocks = _FWD_PLANS.get(key)
        if blocks is None:
            blocks = _FWD_PLANS[key] = fwd_plan(rows, c, x.dtype, branch is not None, align)[2]
        err = fn(x.data_ptr(), None if branch is None else branch.data_ptr(), g32.data_ptr(),
                 b32.data_ptr(), None if r is None else r.data_ptr(), y.data_ptr(), rows, c,
                 code, align, blocks, float(eps), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"layernorm forward kernel launch failed: {error_string(err).decode()} ({err})")
    LAUNCHES["layernorm_fwd"] += 1


_BWD_ARGTYPES = [
    *[ctypes.c_void_p] * 8,  # x, gamma, dy, dr, dx, part, counters, sums
    *[ctypes.c_int] * 5,  # rows, c, dtype, align, blocks
    ctypes.c_float,  # eps
    ctypes.c_void_p,  # stream
]
#: zeroed counters for the backward's column sums, one set a (device,
#: stream). The blocks of a launch count themselves on them to find the last
#: of each group, and the kernel leaves them zero; launches on one stream run
#: one after another, so no two launches share a set at once. (A launch that
#: faults part way leaves a set nonzero, but also the CUDA context unusable.)
_COUNTERS: dict = {}


def _bwd_library():
    lib = _build.load_library("layernorm_bwd")
    fn, plan, err = lib.mmlearn_ln_bwd, lib.mmlearn_ln_bwd_plan, lib.mmlearn_ln_bwd_error_string
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _BWD_ARGTYPES
        plan.restype = ctypes.c_int
        plan.argtypes = [*[ctypes.c_int] * 5, *[ctypes.POINTER(ctypes.c_int)] * 2]
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return fn, plan, err


def _alignment(*tensors) -> int:
    """The largest of 16, 8, 4 bytes that divides every tensor's address."""
    ptrs = [t.data_ptr() for t in tensors if t is not None]
    return next(a for a in (16, 8, 4, 1) if all(p % a == 0 for p in ptrs))


def _launch_bwd(x, gamma, dy, eps: float, dr=None):
    """The backward kernel on a CUDA tensor, one launch: ``(dx, dgamma,
    dbeta)``, the sums in gamma's dtype."""
    c = x.shape[-1]
    rows = x.numel() // c
    code = _DTYPE_CODES[x.dtype]
    dy = dy.to(x.dtype).contiguous()
    if dr is not None:
        dr = dr.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    align = _alignment(x, dy, dr, dx)
    fn, plan, error_string = _bwd_library()
    blocks, part_rows = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = plan(rows, c, code, int(dr is not None), align, ctypes.byref(blocks),
                   ctypes.byref(part_rows))
        if err != 0:
            raise RuntimeError(f"layernorm backward has no launch for rows={rows} C={c}: "
                               f"{error_string(err).decode()} ({err})")
        part = torch.empty(part_rows.value, 2, c, dtype=torch.float64, device=x.device)
        sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        counters = _COUNTERS.get((x.device, stream))
        if counters is None:  # zeroed on this stream, before the launch
            counters = _COUNTERS[x.device, stream] = torch.zeros(1024, dtype=torch.int32,
                                                                 device=x.device)
        g32 = gamma.float().contiguous()
        err = fn(x.data_ptr(), g32.data_ptr(), dy.data_ptr(),
                 None if dr is None else dr.data_ptr(), dx.data_ptr(), part.data_ptr(),
                 counters.data_ptr(), sums.data_ptr(), rows, c, code, align, blocks.value,
                 float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"layernorm backward kernel launch failed: {error_string(err).decode()} ({err})")
    LAUNCHES["layernorm_bwd"] += 1
    return dx, sums[0].to(gamma.dtype), sums[1].to(gamma.dtype)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on cpu or cuda tensors, got {x.device}")
    return True


def _ln_bwd(x, gamma, dy, eps: float, dr=None):
    if not _on_cuda(x):
        dx, dg, db = ln_bwd_reference(x, gamma, dy, eps, dr)
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype)
    report_flops("layernorm_bwd", LAYERNORM_FLOPS)
    return _launch_bwd(x, gamma, dy, eps, dr)


def layernorm_forward(x, gamma, beta, eps: float) -> torch.Tensor:
    """LN by the tensor's device: the plain version on the CPU, K2f on the
    card (reported to the open FLOP counters). The eager route, and the
    implementations of the registered operator ``mmlearn::layernorm``
    (:mod:`.registered`) that a traced program calls."""
    if x.device.type == "cpu":
        return ln_reference(x, gamma, beta, eps)
    y = torch.empty_like(x)
    _launch(x, None, gamma, beta, None, y, eps)
    report_flops("layernorm_fwd", LAYERNORM_FLOPS)
    return y


def add_layernorm_forward(x, branch, gamma, beta, eps: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r, LN(r))`` with ``r = x + branch``, by the tensor's device, as
    :func:`layernorm_forward` (``mmlearn::add_layernorm``)."""
    if x.device.type == "cpu":
        r = x + branch
        return r, ln_reference(r, gamma, beta, eps)
    r = torch.empty_like(x)
    y = torch.empty_like(x)
    _launch(x, branch, gamma, beta, r, y, eps)
    report_flops("layernorm_fwd", LAYERNORM_FLOPS)
    return r, y


def _forwards():
    """The two forwards: the registered operators under ``torch.export``,
    so that the program calls K2f and not its plain version; else the
    direct calls (the operator's dispatch costs the host time a call)."""
    if torch.compiler.is_exporting():
        from mmlearn_tpu_torch.ops import registered

        return registered.layernorm, registered.add_layernorm
    return layernorm_forward, add_layernorm_forward


class LayerNormFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX package's ``_layernorm``: saves x and
    gamma, and runs the backward kernel (the plain backward on a CPU
    tensor)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        y = _forwards()[0](x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _ln_bwd(x, gamma, dy, ctx.eps)
        return dx, dgamma, dbeta, None


class AddLayerNormFunction(torch.autograd.Function):
    """The ``custom_vjp`` of ``_add_layernorm``: saves ``r = x + branch`` and
    gamma; the backward folds the cotangent of ``r`` into ``dx`` and returns
    that ``dx`` to both ``x`` and ``branch``."""

    @staticmethod
    def forward(ctx, x, branch, gamma, beta, eps: float):
        r, y = _forwards()[1](x, branch, gamma, beta, eps)
        ctx.save_for_backward(r, gamma)
        ctx.eps = eps
        return r, y

    @staticmethod
    def backward(ctx, dr_in, dy):
        r, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _ln_bwd(r, gamma, dy, ctx.eps, dr=dr_in)
        return dx, dx, dgamma, dbeta, None


def fused_layernorm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics (flax semantics)."""
    if _on_cuda(x):
        _check(x, gamma, beta)
    return LayerNormFunction.apply(x, gamma, beta, float(eps))


def fused_add_layernorm(
    x: torch.Tensor,
    branch: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + branch; y = LN(r)`` in one pass. Returns ``(r, y)``."""
    if _on_cuda(x):
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
    return AddLayerNormFunction.apply(x, branch, gamma, beta, float(eps))
