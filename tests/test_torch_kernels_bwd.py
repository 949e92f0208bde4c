"""The backward kernels of the PyTorch port -- K1b (fused attention) and K2b
(LayerNorm, add + LayerNorm) -- through their plain versions against the
JAX package on the CPU, and their autograd Functions against autograd.

On the CPU the port's Functions take the plain backward versions, so these
tests hold those versions to the Pallas kernels' function (run in interpreter
mode, as the JAX package's own tests run them) and to autodiff of the JAX
reference math. The CUDA kernels are held to the plain versions on the card
(the ``cuda`` tests below, and ``chip_smoke.py``). Inputs are made from a
seed with numpy and fed to both packages in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.ops.fused_attention import _mha_reference_xla, fused_mha_bwd_interpret
from mmlearn_tpu.ops.fused_norm import fused_layernorm_bwd_interpret
from mmlearn_tpu_torch.modules.layers.transformer_block import Block
from mmlearn_tpu_torch.ops import fused_attention as fa
from mmlearn_tpu_torch.ops import fused_norm as fn

# the JAX package's tolerances for these kernels against autodiff of their
# references (tests/ops/test_fused_attention.py:111, test_fused_norm.py:76):
# f32 sums in another order
ATTN_ATOL = 3e-5
LN_ATOL = 2e-4
# a Function's backward against autograd through its own plain forward: the
# same f32 math with the softmax's delta taken as sum(dout * out) instead of
# sum(p * dp)
AUTOGRAD_ATOL = 1e-5


def _attn_data(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    dout = rng.standard_normal((b, n, h * d)).astype(np.float32)
    return qkv, dout


def _mask(kind, b, n):
    """None, right padding (key 0 always visible) or left padding (early
    causal rows, and a whole sample, see no key)."""
    if kind == "none":
        return None
    mask = np.ones((b, n), bool)
    if kind == "right_pad":
        mask[0, n // 2:] = False
        mask[1, n - 3:] = False
    else:  # "left_pad"
        mask[0, : n // 3] = False
        mask[1] = False
    return mask


def _plain_bwd(qkv, dout, mask, h, causal):
    d = qkv.shape[-1] // (3 * h)
    q = torch.from_numpy(qkv)
    m = None if mask is None else torch.from_numpy(mask)
    out = fa.mha_reference(q, m, h, d ** -0.5, causal)
    return fa.mha_bwd_reference(q, m, out, torch.from_numpy(dout), h, d ** -0.5,
                                causal).numpy()


@pytest.mark.parametrize("kind", ["none", "causal", "causal_right_pad"])
@pytest.mark.parametrize("d", [32, 64])
def test_mha_bwd_plain_matches_pallas_interpret(d, kind):
    b, n, h = 2, 77, 2
    qkv, dout = _attn_data(b, n, h, d, seed=d)
    causal = kind != "none"
    mask = _mask("right_pad", b, n) if kind == "causal_right_pad" else None
    want = fused_mha_bwd_interpret(
        jnp.asarray(qkv), jnp.asarray(dout), None if mask is None else jnp.asarray(mask),
        num_heads=h, causal=causal,
    )
    got = _plain_bwd(qkv, dout, mask, h, causal)
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_ATOL)


@pytest.mark.parametrize("mask_kind", ["none", "right_pad", "left_pad"])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_bwd_plain_matches_jax_autodiff(causal, mask_kind):
    """Autodiff of ``_mha_reference_xla``, the gradient the JAX package
    computes off the TPU; with a left-pad mask some rows see no key, and
    there the plain backward (like autodiff) gives dq = dk = 0."""
    b, n, h, d = 2, 29, 2, 32
    qkv, dout = _attn_data(b, n, h, d, seed=7)
    mask = _mask(mask_kind, b, n)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda x: _mha_reference_xla(x, jmask, h, d ** -0.5, causal),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(_plain_bwd(qkv, dout, mask, h, causal), np.asarray(want),
                               atol=ATTN_ATOL)


@pytest.mark.parametrize("mask_kind", ["none", "right_pad", "left_pad"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_mha_function_matches_autograd(causal, mask_kind):
    b, n, h, d = 2, 13, 2, 8
    qkv, dout = _attn_data(b, n, h, d, seed=3)
    m = _mask(mask_kind, b, n)
    m = None if m is None else torch.from_numpy(m)
    x = torch.from_numpy(qkv).requires_grad_()
    out = fa.fused_mha(x, m, num_heads=h, causal=causal)
    assert type(out.grad_fn).__name__ == "FusedMHAFunctionBackward"
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(dout))
    x2 = torch.from_numpy(qkv).requires_grad_()
    (want,) = torch.autograd.grad(fa.mha_reference(x2, m, h, d ** -0.5, causal), x2,
                                  torch.from_numpy(dout))
    torch.testing.assert_close(got, want, atol=AUTOGRAD_ATOL, rtol=0)


def _ln_data(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x, branch, dy, dr = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, branch, dy, dr, gamma, beta


@pytest.mark.parametrize("with_dr", [False, True], ids=["ln", "add_ln"])
@pytest.mark.parametrize("shape", [(2, 77, 512), (64, 256)], ids=str)
def test_ln_bwd_plain_matches_pallas_interpret(shape, with_dr):
    x, _, dy, dr, gamma, _ = _ln_data(shape, seed=len(shape))
    want = fused_layernorm_bwd_interpret(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(dy), eps=1e-6,
        dr=jnp.asarray(dr) if with_dr else None,
    )
    got = fn.ln_bwd_reference(torch.from_numpy(x), torch.from_numpy(gamma),
                              torch.from_numpy(dy), 1e-6,
                              torch.from_numpy(dr) if with_dr else None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LN_ATOL)


def test_layernorm_functions_match_autograd():
    x, branch, dy, dr, gamma, beta = (torch.from_numpy(a) for a in _ln_data((3, 7, 48), 5))
    leaves = [t.clone().requires_grad_() for t in (x, branch, gamma, beta)]
    xs, bs, gs, be = leaves
    y = fn.fused_layernorm(xs, gs, be, eps=1e-5)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    got = torch.autograd.grad(y, (xs, gs, be), dy)
    want = torch.autograd.grad(fn.ln_reference(xs, gs, be, 1e-5), (xs, gs, be), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=AUTOGRAD_ATOL, rtol=0)

    r, y = fn.fused_add_layernorm(xs, bs, gs, be, eps=1e-6)
    assert type(y.grad_fn).__name__ == "AddLayerNormFunctionBackward"
    got = torch.autograd.grad((r, y), leaves, (dr, dy))
    r2 = xs + bs
    want = torch.autograd.grad((r2, fn.ln_reference(r2, gs, be, 1e-6)), leaves, (dr, dy))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=AUTOGRAD_ATOL, rtol=0)


def test_block_trains_through_the_functions():
    """Every weight of a block gets a nonzero gradient: the kernels'
    outputs stay in the autograd graph (the Functions are what the card
    runs too; on the card they launch the kernels instead)."""
    block = Block(dim=32, num_heads=2, causal=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 32))
                         .astype(np.float32))
    mask = torch.ones(2, 9, dtype=torch.int32)
    mask[1, 6:] = 0
    block(x, mask).square().sum().backward()
    for name, p in block.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


@pytest.mark.parametrize("with_dr", [False, True], ids=["ln", "add_ln"])
def test_ln_bwd_takes_plain_version_only_on_cpu(with_dr):
    """The backward's wrapper takes ``ln_bwd_reference`` for a CPU tensor
    (no kernel runs; the sums in gamma's dtype) and raises for a device
    other than the CPU and CUDA."""
    x, _, dy, dr, gamma, _ = (torch.from_numpy(a) for a in _ln_data((4, 9, 40), 6))
    d_r = dr if with_dr else None
    before = dict(fn.LAUNCHES)
    got = fn._ln_bwd(x, gamma.bfloat16(), dy, 1e-6, d_r)
    assert dict(fn.LAUNCHES) == before
    want = fn.ln_bwd_reference(x, gamma.bfloat16(), dy, 1e-6, d_r)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.bfloat16(), rtol=0, atol=0)
    meta = torch.empty(4, 9, 40, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn._ln_bwd(meta, gamma, meta, 1e-6, meta if with_dr else None)


def test_cuda_wrappers_reject_other_devices():
    meta = torch.empty(2, 5, 3 * 2 * 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.fused_mha(meta, num_heads=2)
    before = dict(fa.LAUNCHES), dict(fn.LAUNCHES)
    qkv = torch.from_numpy(_attn_data(1, 5, 2, 32, 0)[0]).requires_grad_()
    fa.fused_mha(qkv, num_heads=2).sum().backward()
    assert (dict(fa.LAUNCHES), dict(fn.LAUNCHES)) == before  # no kernel ran


# ----------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["none", "right_pad", "left_pad"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_cuda_mha_bwd_matches_plain(d, causal, mask_kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++ for sm_90a)")
    b, n, h = 2, 77, 4
    qkv, dout = (torch.from_numpy(a).cuda() for a in _attn_data(b, n, h, d, seed=d))
    m = _mask(mask_kind, b, n)
    m = None if m is None else torch.from_numpy(m).cuda()
    # f32: sums in another order; bf16: one rounding of the output's
    # magnitude (p and ds are rounded to bf16 from f32 values that differ
    # by f32 rounding)
    for dtype, (atol, rtol) in ((torch.float32, (2e-5, 0)), (torch.bfloat16, (2e-2, 1e-2))):
        x = qkv.to(dtype).requires_grad_()
        out = fa.fused_mha(x, m, num_heads=h, causal=causal)
        before = dict(fa.LAUNCHES)
        (got,) = torch.autograd.grad(out, x, dout.to(dtype))
        assert fa.LAUNCHES == {**before, "fused_mha_bwd": before["fused_mha_bwd"] + 2}
        want = fa.mha_bwd_reference(x.detach(), m, out.detach(), dout.to(dtype), h,
                                    d ** -0.5, causal)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
# (8, 197, 768), (8, 77, 512), (8, 118, 384): the towers' and the I-JEPA
# predictor's widths, one warp a row; (256, 77, 512): many rows a warp, as
# the train step at batch 256; (5, 300): a ragged C, the wide kernel
@pytest.mark.parametrize("shape", [(8, 197, 768), (8, 77, 512), (8, 118, 384), (256, 77, 512),
                                   (5, 300)], ids=str)
def test_cuda_ln_bwd_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++)")
    x, branch, dy, dr, gamma, _ = (torch.from_numpy(a).cuda() for a in _ln_data(shape, 3))
    for dtype, (atol, rtol) in ((torch.float32, (2e-5, 1e-5)), (torch.bfloat16, (2e-2, 1e-2))):
        xd = x.to(dtype)
        for d_r in (None, dr.to(dtype)):
            before = dict(fn.LAUNCHES)
            got = fn._launch_bwd(xd, gamma, dy.to(dtype), 1e-6, d_r)
            assert fn.LAUNCHES == {**before, "layernorm_bwd": before["layernorm_bwd"] + 1}
            want = fn.ln_bwd_reference(xd, gamma, dy.to(dtype), 1e-6, d_r)
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=rtol)
            # dgamma/dbeta: f32 sums over every row, in another order
            for g, w in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)
            # in a fixed order: the same bits on a second run
            again = fn._launch_bwd(xd, gamma, dy.to(dtype), 1e-6, d_r)
            for g, w in zip(again, got):
                torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_ln_bwd_on_two_streams_at_once():
    """Backwards launched on two streams at once each count their blocks on
    counters of their own: each stream has its own set, and every result
    equals the same backward's on one stream, bit for bit. One stream runs
    the I-JEPA predictor's backward, whose blocks fill the card and retire
    one by one at its end; the other a stream of small backwards whose
    blocks run on the SMs those free, and count while the large one's still
    do. Both queues fill behind a sleep, so that they start together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++)")
    data = []
    for shape, seed in (((1024, 118, 384), 7), ((2, 77, 512), 8)):
        x, _, dy, dr, gamma, _ = (torch.from_numpy(a).cuda() for a in _ln_data(shape, seed))
        data.append((x.bfloat16(), gamma, dy.bfloat16(), dr.bfloat16()))
    want = [fn._launch_bwd(x, g, dy, 1e-6, dr) for x, g, dy, dr in data]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for stream in streams:
        with torch.cuda.stream(stream):
            torch.cuda._sleep(50_000_000)  # ~25 ms, while both queues fill
    for i in range(256):
        for k, (stream, (x, g, dy, dr), out) in enumerate(zip(streams, data, got)):
            if k == 0 and i % 32:
                continue  # eight large backwards beside 256 small ones
            with torch.cuda.stream(stream):
                out.append(fn._launch_bwd(x, g, dy, 1e-6, dr))
    torch.cuda.synchronize()
    keys = {key for key in fn._COUNTERS if key[0] == data[0][0].device}
    assert {s.cuda_stream for s in streams} <= {stream for _, stream in keys}
    for outs, w in zip(got, want):
        for o in outs:
            for a, b in zip(o, w):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
