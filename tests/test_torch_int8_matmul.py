"""Kernel K5 of the PyTorch port (the quantizing int8 product) and its
switchback product against the JAX package on the CPU.

The port's plain version of K5 is held to the JAX package's Pallas kernel in
interpret mode and to its XLA-composed int8 product, and the switchback
gradients to ``jax.grad`` of its ``switchback_matmul`` with the kernel in
interpret mode, at the JAX test's tolerance (atol and rtol 1e-5,
tests/modules/test_quantization.py:285-329), at ragged M, N and K. The
weight is ``(K, N)`` in the JAX package and ``(N, K)`` in the port. The CUDA
kernel itself runs only on a card (the ``cuda`` test below, and
``chip_smoke.py``). Inputs are made from a seed with numpy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.modules.layers.quantization import _int8_fwd as jax_int8_fwd
from mmlearn_tpu.ops import int8_matmul as jim
from mmlearn_tpu_torch.ops import int8_matmul as im

TOL = dict(atol=1e-5, rtol=1e-5)

# (leading dims of x, K, N): the JAX test's shape, the least M the routing
# admits, and ragged M, N and K
SHAPES = [((3, 40), 96, 160), ((8,), 128, 128), ((37,), 200, 160), ((2, 65), 100, 300)]


def _data(lead, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    c = rng.standard_normal((*lead, n)).astype(np.float32)
    return x, w, c


def _port_weight(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.T))


@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_int8_qmm_matches_pallas_interpret_and_composed(lead, k, n):
    x, w, _ = _data(lead, k, n, seed=k + n)
    qw, sw = jim.quantize_weight(jnp.asarray(w), axis=0)
    want_kernel = np.asarray(jim.int8_qmm(jnp.asarray(x), qw, sw, block_m=16, block_n=128,
                                          interpret=True))
    want_xla = np.asarray(jax_int8_fwd(jnp.asarray(x), jnp.asarray(w)))
    pq, ps = im.quantize_weight(_port_weight(w))
    # the same quantizer: the ints and scales agree exactly
    np.testing.assert_array_equal(pq.numpy(), np.asarray(qw).T)
    np.testing.assert_array_equal(ps.numpy().ravel(), np.asarray(sw).ravel())
    got = im.int8_qmm(torch.from_numpy(x), pq, ps)
    assert got.shape == (*lead, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)


def test_int8_qmm_bf16_matches_composed():
    """bf16 in, bf16 out: the same ints and the same f32 dequantization, so
    at most the output's rounding differs (rtol 2^-8, one bf16 step)."""
    x, w, _ = _data((50,), 200, 136, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_int8_fwd(xb, jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    got = im.int8_qmm(torch.from_numpy(x).bfloat16(),
                      *im.quantize_weight(_port_weight(w).bfloat16()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=0)


def test_supports_int8_qmm_matches_jax():
    for m in (1, 7, 8, 50_432):
        for k in (1, 96, 8192, 8193):
            for n in (1, 127, 128, 3072):
                assert im.supports_int8_qmm(m, k, n) == jim.supports_int8_qmm(m, k, n)


def test_plain_version_keeps_the_int32_sums_exact():
    """Integer operands whose rows (x) and weight rows reach 127 quantize
    with scale 1, so the product is the exact integer one: at K = 3072 the
    sums pass 2^24, where an f32 accumulation would round."""
    rng = np.random.default_rng(0)
    k = 3072
    x = np.full((8, k), 127.0, np.float32)
    x[:, ::2] = rng.integers(100, 128, (8, k // 2))
    w = np.full((128, k), 127.0, np.float32)
    want = x.astype(np.float64) @ w.T.astype(np.float64)
    assert want.max() > 2 ** 24
    got = im.int8_qmm(torch.from_numpy(x), *im.quantize_weight(torch.from_numpy(w)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(24, 96, 160), (20, 256, 64), (12, 200, 136)])
def test_switchback_grads_match_jax(m, k, n, monkeypatch):
    """Forward, dgrad (both K5 where the shape routes there) and the exact
    wgrad against ``jax.grad`` with the Pallas kernel in interpret mode."""
    monkeypatch.setenv("MMLEARN_INT8_QMM_INTERPRET", "1")
    x, w, c = _data((m,), k, n, seed=m)

    def loss(x, w):
        return jnp.sum(jim.switchback_matmul(x, w) * c)

    want_y = np.asarray(jim.switchback_matmul(jnp.asarray(x), jnp.asarray(w)))
    want_gx, want_gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _port_weight(w).requires_grad_()
    y = im.switchback_matmul(xt, wt)
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(want_gw), rtol=1e-5, atol=1e-6)


def test_switchback_routes_shapes_as_the_jax_package(monkeypatch):
    """K5 takes a product where ``supports_int8_qmm`` admits its shape (the
    forward's, and the dgrad's with K and N swapped); the composed product
    takes the rest."""
    calls = []
    real = im.int8_qmm

    def spy(a, qw, sw, bias=None):
        calls.append((math.prod(a.shape[:-1]), a.shape[-1], qw.shape[0]))
        return real(a, qw, sw, bias)

    monkeypatch.setattr(im, "int8_qmm", spy)
    want = []
    for m, k, n in [(24, 96, 160), (20, 256, 64), (4, 256, 256), (16, 8200, 128)]:
        x = torch.randn(m, k, generator=torch.Generator().manual_seed(m), requires_grad=True)
        w = torch.randn(n, k, generator=torch.Generator().manual_seed(n), requires_grad=True)
        im.switchback_matmul(x, w).sum().backward()
        want += [s for s in ((m, k, n), (m, n, k)) if jim.supports_int8_qmm(*s)]
    assert calls == want == [(24, 96, 160), (20, 64, 256), (16, 128, 8200)]


@pytest.mark.parametrize("m,k,n", [(24, 96, 160), (20, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_switchback_bias_is_the_separate_add_bit_for_bit(m, k, n, dtype):
    """``switchback_matmul(x, w, bias)`` (K5's bias epilogue where the
    routing takes K5, the composed product and an add where it does not)
    against ``switchback_matmul(x, w) + bias``, as ``Int8Dense`` computed it
    before: the output and the gradients of x, w and the bias equal bit for
    bit."""
    rng = np.random.default_rng(m)
    x, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((2, m, k), (2, m, n)))
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    outs, grads = [], []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        xl, wl, bl = leaves
        y = im.switchback_matmul(xl, wl, bl) if fused else im.switchback_matmul(xl, wl) + bl
        (y * c).sum().backward()
        outs.append(y.detach())
        grads.append([t.grad for t in leaves])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_qmm_runs_on_cpu_or_cuda_only():
    x = torch.empty(8, 64, device="meta")
    qw = torch.empty(128, 64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        im.int8_qmm(x, qw, torch.empty(128, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [(8, 128, 128, torch.bfloat16),
                                         (37, 200, 160, torch.bfloat16),
                                         (300, 96, 520, torch.float32),
                                         (77, 3072, 768, torch.bfloat16),
                                         (40, 8192, 136, torch.float32)])
def test_cuda_int8_qmm_matches_plain(m, k, n, dtype):
    """K5 on the card against its plain version: the same ints and the same
    dequantization, so the outputs agree exactly (chip_smoke.py reads 0). K %
    16 == 0 takes the TMA path, K = 200 the byte path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5 is CUDA C++)")
    x, w, _ = _data((m,), k, n, seed=m)
    xt = torch.from_numpy(x).cuda().to(dtype)
    qw, sw = im.quantize_weight(_port_weight(w).cuda().to(dtype))
    before = dict(im.LAUNCHES)
    got = im.int8_qmm(xt, qw, sw)
    torch.cuda.synchronize()
    path = "int8_qmm" if k % 16 == 0 else "int8_qmm_bytes"
    assert im.LAUNCHES == {**before, path: before[path] + 1}
    torch.testing.assert_close(got, im.int8_qmm_reference(xt, qw, sw), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 768, 520), (37, 200, 160)], ids=["tma", "bytes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_qmm_bias_matches_plain(m, k, n, dtype):
    """K5 with a bias on each of its paths against its plain version with
    the bias and against the plain product plus a separate add: equal bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5 is CUDA C++)")
    x, w, _ = _data((m,), k, n, seed=k)
    xt = torch.from_numpy(x).cuda().to(dtype)
    qw, sw = im.quantize_weight(_port_weight(w).cuda().to(dtype))
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    b = b.cuda().to(dtype)
    got = im.int8_qmm(xt, qw, sw, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, im.int8_qmm_reference(xt, qw, sw, b), rtol=0, atol=0)
    torch.testing.assert_close(got, im.int8_qmm_reference(xt, qw, sw) + b, rtol=0, atol=0)
