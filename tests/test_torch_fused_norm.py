"""Kernel K2 (LayerNorm, residual-add + LayerNorm) of the PyTorch port
against the JAX package's Pallas kernels, run in interpreter mode on the CPU.

On the CPU the port's wrappers take their plain version; the CUDA kernels
are held to it on the card (the ``cuda`` test below, and ``chip_smoke.py``).
The JAX package is imported inside the tests that compare with it, so that
the ``cuda`` test also runs where JAX is absent::

    python -m pytest --noconftest -m cuda tests/test_torch_fused_norm.py
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from mmlearn_tpu_torch.ops import fused_norm as fn

# the JAX package's own tolerance for the kernel against flax LayerNorm
ATOL = 1e-5
SHAPES = [(2, 197, 768), (2, 77, 512), (16, 128)]


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    branch = rng.standard_normal(shape).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, branch, gamma, beta


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_layernorm_matches_pallas_interpret(shape, eps):
    import jax.numpy as jnp

    from mmlearn_tpu.ops.fused_norm import fused_layernorm_interpret

    x, _, gamma, beta = _data(shape, seed=len(shape))
    want = fused_layernorm_interpret(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), eps=eps)
    got = fn.fused_layernorm(torch.from_numpy(x), torch.from_numpy(gamma),
                             torch.from_numpy(beta), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_add_layernorm_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from mmlearn_tpu.ops.fused_norm import fused_add_layernorm_interpret

    x, branch, gamma, beta = _data(shape, seed=7)
    r_want, y_want = fused_add_layernorm_interpret(
        jnp.asarray(x), jnp.asarray(branch), jnp.asarray(gamma), jnp.asarray(beta),
        eps=1e-6,
    )
    r_got, y_got = fn.fused_add_layernorm(
        torch.from_numpy(x), torch.from_numpy(branch), torch.from_numpy(gamma),
        torch.from_numpy(beta), eps=1e-6,
    )
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_want), atol=1e-6)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), atol=ATOL)


def test_bf16_output_is_cast_from_f32_statistics():
    """bf16 input: statistics in f32 on the widened input, output rounded
    once to bf16 -- the plain version of ``_ln_ref``."""
    x, _, gamma, beta = _data((4, 64), seed=1)
    xb = torch.from_numpy(x).bfloat16()
    got = fn.fused_layernorm(xb, torch.from_numpy(gamma), torch.from_numpy(beta))
    want = fn.ln_reference(xb.float(), torch.from_numpy(gamma),
                           torch.from_numpy(beta), 1e-6).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_take_plain_version_only_on_cpu():
    x, branch, gamma, beta = (torch.from_numpy(a) for a in _data((3, 32), seed=2))
    before = fn.LAUNCHES["layernorm_fwd"]
    fn.fused_layernorm(x, gamma, beta)
    fn.fused_add_layernorm(x, branch, gamma, beta)
    assert fn.LAUNCHES["layernorm_fwd"] == before  # no kernel ran
    meta = torch.empty(3, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn.fused_layernorm(meta, gamma, beta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn.fused_add_layernorm(meta, meta, gamma, beta)


def test_module_runs_with_triton_blocked(monkeypatch):
    """A fresh copy of the module, loaded with ``triton`` blocked, runs both
    wrappers and their backward on CPU tensors as the module does."""
    monkeypatch.setitem(sys.modules, "triton", None)
    monkeypatch.setitem(sys.modules, "triton.language", None)
    spec = importlib.util.spec_from_file_location("fused_norm_without_triton", fn.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    x, branch, gamma, beta = (torch.from_numpy(a).requires_grad_()
                              for a in _data((3, 5, 64), seed=4))
    dy = torch.from_numpy(_data((3, 5, 64), seed=5)[0])
    for impl in (mod, fn):
        y = impl.fused_layernorm(x, gamma, beta)
        r, y2 = impl.fused_add_layernorm(x, branch, gamma, beta)
        grads = torch.autograd.grad((y, r, y2), (x, branch, gamma, beta), (dy, dy, dy))
        if impl is mod:
            want = (y, r, y2, *grads)
        else:
            for got, w in zip((y, r, y2, *grads), want):
                torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_package_imports_triton_nowhere():
    root = os.path.dirname(os.path.dirname(fn.__file__))
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    lines = [line.strip() for line in f]
                assert not [line for line in lines if line.startswith(
                    ("import triton", "from triton"))], os.path.join(dirpath, name)


# (C, dtype, row-pointer alignment) -> the forward's kernel: (bytes an
# access, vectors of eight a lane) of the rows kernel, (0, 0) the wide kernel
ROUTES = [
    (384, torch.bfloat16, 16, (16, 2)), (512, torch.bfloat16, 16, (16, 2)),
    (768, torch.bfloat16, 16, (16, 4)), (1024, torch.bfloat16, 16, (16, 4)),
    (1280, torch.bfloat16, 16, (16, 8)), (1408, torch.bfloat16, 16, (16, 8)),
    (136, torch.bfloat16, 16, (16, 1)), (128, torch.bfloat16, 16, (0, 0)),
    (300, torch.bfloat16, 16, (0, 0)), (8192, torch.bfloat16, 16, (0, 0)),
    (768, torch.bfloat16, 8, (2, 4)), (768, torch.bfloat16, 1, (2, 4)),
    (384, torch.float32, 16, (16, 2)), (2048, torch.float32, 16, (16, 8)),
    (2056, torch.float32, 16, (0, 0)), (768, torch.float32, 4, (4, 4)),
]


@pytest.mark.parametrize("c,dtype,align,want", ROUTES, ids=str)
def test_forward_route(c, dtype, align, want):
    """Every width of the towers on the rows kernel, next_pow2(C) / 256
    vectors of eight a lane (C = 1408: eight, the last two and a half
    masked), whatever the alignment (value by value where a vector is not
    16-byte aligned); C <= 128, a C that is not a multiple of 8, and C past
    2048 on the wide kernel."""
    assert fn.fwd_route(c, dtype, align) == want


# the route cases on the card: (rows, C), then misaligned rows
CUDA_SHAPES = [(8, 197, 768), (8, 77, 512), (8, 118, 384), (2, 77, 1024), (2, 257, 1280),
               (2, 257, 1408), (37, 136), (37, 300), (3, 8192), (37, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=str)
def test_cuda_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    x, branch, gamma, beta = (torch.from_numpy(a).cuda() for a in _data(shape, 3))
    for dtype, (atol, rtol) in ((torch.float32, (2e-5, 0)), (torch.bfloat16, (2e-2, 1e-2))):
        # contiguous views at an offset of 0, 1 and 4 elements: aligned to
        # 16 bytes, to the element only, and (bf16) to 8 bytes
        for offset in (0, 1, 4):
            n = x.numel()
            xd = torch.empty(n + offset, dtype=dtype, device="cuda")[offset:].view(x.shape)
            bd = torch.empty(n + offset, dtype=dtype, device="cuda")[offset:].view(x.shape)
            xd.copy_(x)
            bd.copy_(branch)
            align = fn._alignment(xd, bd)
            route = fn.fwd_route(shape[-1], dtype, align)
            rows = n // shape[-1]
            for has_add in (False, True):
                assert fn.fwd_plan(rows, shape[-1], dtype, has_add, align)[:2] == route
            before = fn.LAUNCHES["layernorm_fwd"]
            y = fn.fused_layernorm(xd, gamma, beta)
            r, y2 = fn.fused_add_layernorm(xd, bd, gamma, beta)
            assert fn.LAUNCHES["layernorm_fwd"] == before + 2
            want, want2 = (fn.ln_reference(a, gamma, beta, 1e-6) for a in (xd, xd + bd))
            torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)
            torch.testing.assert_close(r, xd + bd, atol=0, rtol=0)
            torch.testing.assert_close(y2.float(), want2.float(), atol=atol, rtol=rtol)

