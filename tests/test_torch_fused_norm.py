"""Kernel K2 (LayerNorm, residual-add + LayerNorm) of the PyTorch port
against the JAX package's Pallas kernels, run in interpreter mode on the CPU.

On the CPU the port's wrappers take their plain version; the Triton kernel
is held to it on the card (the ``cuda`` test below, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.ops.fused_norm import (
    fused_add_layernorm_interpret,
    fused_layernorm_interpret,
)
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
    x, _, gamma, beta = _data(shape, seed=len(shape))
    want = fused_layernorm_interpret(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), eps=eps)
    got = fn.fused_layernorm(torch.from_numpy(x), torch.from_numpy(gamma),
                             torch.from_numpy(beta), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_add_layernorm_matches_pallas_interpret(shape):
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 197, 768), (8, 77, 512), (5, 300)], ids=str)
def test_cuda_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is Triton)")
    x, branch, gamma, beta = (torch.from_numpy(a).cuda() for a in _data(shape, 3))
    for dtype, (atol, rtol) in ((torch.float32, (2e-5, 0)), (torch.bfloat16, (2e-2, 1e-2))):
        xd, bd = x.to(dtype), branch.to(dtype)
        before = fn.LAUNCHES["layernorm_fwd"]
        y = fn.fused_layernorm(xd, gamma, beta)
        r, y2 = fn.fused_add_layernorm(xd, bd, gamma, beta)
        assert fn.LAUNCHES["layernorm_fwd"] == before + 2
        torch.testing.assert_close(y.float(), fn.ln_reference(xd, gamma, beta, 1e-6).float(),
                                   atol=atol, rtol=rtol)
        torch.testing.assert_close(r, xd + bd, atol=0, rtol=0)
        torch.testing.assert_close(
            y2.float(), fn.ln_reference(xd + bd, gamma, beta, 1e-6).float(),
            atol=atol, rtol=rtol,
        )
