"""The long-sequence attention of the PyTorch port -- K3 (flash attention,
forward and backward) -- through its plain versions against the JAX package
on the CPU, and its autograd Function against ``jax.vjp``.

On the CPU the port's Function takes the plain versions, so these tests hold
them to ``_attention_xla`` (the function the JAX package computes off the
TPU), to its autodiff, and to the Pallas kernels run in interpreter mode as
the JAX package's own tests run them (tests/ops/test_flash_attention.py).
The CUDA kernels are held to the plain versions on the card (the ``cuda``
tests below, and ``chip_smoke.py``). Inputs are made from a seed with numpy
and fed to both packages in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.ops.flash_attention import (
    _attention_xla,
    _flash_backward_pallas,
    _flash_forward_pallas,
    flash_attention_interpret,
)
from mmlearn_tpu_torch.ops import flash_attention as fl

# the JAX package's tolerances (tests/ops/test_flash_attention.py): the
# forward against _attention_xla 2e-5, the backward kernels against autodiff
# 3e-4 (f32 sums in another order)
FWD_ATOL = 2e-5
BWD_ATOL = 3e-4
# the port's plain backward against autodiff of the same f32 math: the
# softmax's delta taken as sum(dout * out) instead of sum(p * dp)
VJP_ATOL = 2e-5


def _data(b, h, n, d, seed, nk=None):
    rng = np.random.default_rng(seed)
    nk = nk or n
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return q, k, v, g


def _mask(kind, b, n, seed=0):
    """None; random keys with key 0 visible (every row sees a key, also under
    a causal mask); right padding; left padding (early causal rows see no
    key); one sample wholly masked."""
    if kind == "none":
        return None
    mask = np.ones((b, n), bool)
    if kind == "random":
        mask = np.random.default_rng(seed).random((b, n)) > 0.3
        mask[:, 0] = True
    elif kind == "right_pad":
        mask[0, n // 2:] = False
    elif kind == "left_pad":
        mask[0, : n // 3] = False
    else:  # "empty_sample"
        mask[1] = False
    return mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


MASKS = ["none", "random", "right_pad", "left_pad", "empty_sample"]


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 64, 32, None), (2, 2, 197, 16, None),
                                   (2, 2, 40, 16, 56), (2, 2, 56, 16, 40),
                                   (2, 2, 65, 80, None), (2, 2, 65, 88, None)],
                         ids=["aligned", "unaligned", "nq<nk", "nq>nk", "d80", "d88"])
def test_attention_reference_matches_xla(shape, causal, mask_kind):
    """Masks, causal (diagonal offset by N_k - N_q), unaligned lengths, rows
    that see no key: atol 2e-5, the JAX package's own for its kernel."""
    b, h, n, d, nk = shape
    q, k, v, _ = _data(b, h, n, d, seed=n, nk=nk)
    mask = _mask(mask_kind, b, nk or n)
    want = _attention_xla(*_j(q, k, v, mask), d ** -0.5, causal)
    got = fl.attention_reference(*_t(q, k, v, mask), d ** -0.5, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("mask_kind", ["none", "random", "empty_sample"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [128, 256])
def test_flash_fwd_reference_matches_pallas_interpret(n, causal, mask_kind):
    """At lengths that are multiples of the kernel's 128 tile the Pallas
    kernel pads nothing: output and log-sum-exp agree (atol 2e-5; the
    log-sum-exp of a row that sees no key is NEG in both). Under a causal
    mask the Pallas kernel skips key blocks above the diagonal even with a
    key mask, so a row that sees no key averages V over the keys up to its
    own block there, over all N_k in ``_attention_xla`` and the port: that
    sample's output is compared with ``_attention_xla`` instead."""
    b, h, d = 2, 2, 16
    q, k, v, _ = _data(b, h, n, d, seed=n + 1)
    mask = _mask(mask_kind, b, n)
    jmask = jnp.ones((b, n), bool) if mask is None else jnp.asarray(mask)
    want, want_lse = _flash_forward_pallas(*_j(q, k, v), jmask, d ** -0.5, causal, 128, 128,
                                           interpret=True)
    got, lse = fl.flash_fwd_reference(*_t(q, k, v, mask), d ** -0.5, causal)
    want = np.array(want)
    if causal and mask_kind == "empty_sample":
        want[1] = np.asarray(_attention_xla(*_j(q, k, v, mask), d ** -0.5, causal))[1]
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(b, h, n),
                               atol=FWD_ATOL, rtol=0)
    if mask_kind == "empty_sample":
        assert bool((lse[1] == fl.NEG).all())


def test_padded_tail_of_a_masked_row_follows_xla_not_the_pallas_kernel():
    """N = 200 pads to 256 keys in the Pallas kernel. A sample whose every key
    is masked averages V over all 256 there, over the 200 real keys in
    ``_attention_xla`` and in the port. The sample with visible keys agrees
    everywhere."""
    b, h, n, d = 2, 2, 200, 16
    q, k, v, _ = _data(b, h, n, d, seed=3)
    mask = _mask("empty_sample", b, n)
    want = np.asarray(_attention_xla(*_j(q, k, v, mask), d ** -0.5, False))
    pallas = np.asarray(flash_attention_interpret(*_j(q, k, v, mask)))
    got = fl.attention_reference(*_t(q, k, v, mask), d ** -0.5, False).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    np.testing.assert_allclose(pallas[0], want[0], atol=FWD_ATOL)
    assert np.abs(pallas[1] - want[1]).max() > 1e-2  # 3.9e-2 when written


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [40, 64])
def test_flash_bwd_reference_matches_pallas_interpret(n, causal):
    """The backward kernels at 16 x 16 tiles (the JAX package's own test),
    on masks where every row sees a key: atol 3e-4."""
    b, h, d = 1, 2, 16
    q, k, v, g = _data(b, h, n, d, seed=n + 2)
    mask = _mask("random", b, n, seed=n)
    jq, jk, jv, jm, jg = _j(q, k, v, mask, g)
    out, lse = _flash_forward_pallas(jq, jk, jv, jm, d ** -0.5, causal, 16, 16, interpret=True)
    want = _flash_backward_pallas(jq, jk, jv, jm, out, lse, jg, d ** -0.5, causal, 16, 16,
                                  interpret=True)
    lse = torch.from_numpy(np.array(lse)).reshape(b, h, -1)[..., :n]
    got = fl.flash_bwd_reference(*_t(q, k, v, mask), torch.from_numpy(np.array(out)), lse,
                                 torch.from_numpy(g), d ** -0.5, causal)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=BWD_ATOL, err_msg=f"d{name}")


def _vjp(q, k, v, mask, g, causal):
    d = q.shape[-1]
    _, vjp = jax.vjp(lambda q, k, v: _attention_xla(q, k, v, mask, d ** -0.5, causal),
                     *_j(q, k, v))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_reference_matches_jax_autodiff(causal, mask_kind):
    """Autodiff of ``_attention_xla`` everywhere, rows that see no key
    included: there dq = 0, dk gets nothing from them, and dv gets dout / N_k
    from each (the TPU kernels differ on such rows)."""
    b, h, n, d = 2, 2, 77, 32
    q, k, v, g = _data(b, h, n, d, seed=11)
    mask = _mask(mask_kind, b, n)
    want = _vjp(q, k, v, None if mask is None else jnp.asarray(mask), g, causal)
    tq, tk, tv, tm = _t(q, k, v, mask)
    out, lse = fl.flash_fwd_reference(tq, tk, tv, tm, d ** -0.5, causal)
    got = fl.flash_bwd_reference(tq, tk, tv, tm, out, lse, torch.from_numpy(g), d ** -0.5,
                                 causal)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=VJP_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("mask_kind", ["none", "left_pad", "empty_sample"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_matches_jax_vjp(causal, mask_kind):
    """``flash_attention`` through autograd against ``jax.vjp``, with N_q !=
    N_k under causal as well: atol 2e-5."""
    b, h, n, nk, d = 2, 2, 30, 45, 32
    q, k, v, g = _data(b, h, n, d, seed=5, nk=nk)
    mask = _mask(mask_kind, b, nk)
    want = _vjp(q, k, v, None if mask is None else jnp.asarray(mask), g, causal)
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = fl.flash_attention(*leaves, None if mask is None else torch.from_numpy(mask),
                             causal=causal)
    out.backward(torch.from_numpy(g))
    for name, a, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=VJP_ATOL,
                                   err_msg=f"d{name}")


def test_cpu_path_launches_nothing_and_other_devices_raise():
    q, k, v, _ = _t(*_data(1, 2, 5, 32, seed=0))
    before = dict(fl.LAUNCHES)
    fl.flash_attention(q.requires_grad_(), k, v).sum().backward()
    assert fl.LAUNCHES == before
    meta = torch.empty(1, 2, 5, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fl.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="mask"):
        fl.flash_attention(q, k, v, torch.ones(1, 1, 5, dtype=torch.bool))


def test_layout_reads_strided_views_in_place():
    """The q, k, v views of a head-major packed projection qualify as they
    are (unit last stride, 16-byte rows); a transposed view is copied."""
    qkv = torch.zeros(2, 7, 4 * 3 * 32, dtype=torch.bfloat16)
    q, k, v = qkv.view(2, 7, 4, 3, 32).permute(3, 0, 2, 1, 4).unbind(0)
    for t in (q, k, v):
        assert fl._layout(t).data_ptr() == t.data_ptr()
    odd = torch.zeros(2, 4, 32, 7, dtype=torch.bfloat16).transpose(2, 3)
    assert fl._layout(odd).is_contiguous()
    assert list(fl._strides(q)) == [7 * 384, 96, 384]


# ----------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 80, 88])
def test_cuda_flash_matches_plain(d, causal, mask_kind):
    """K3f and K3b against their plain versions at N = 200 (a ragged tile):
    f32 to 2e-5 (sums in another order); bf16 to 2e-2 + 1e-2 relative (p and
    ds rounded to bf16 from f32 values that differ in their last bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    b, h, n = 2, 3, 200
    q, k, v, g = (t.cuda() for t in _t(*_data(b, h, n, d, seed=d)))
    mask = _mask(mask_kind, b, n)
    mask = None if mask is None else torch.from_numpy(mask).cuda()
    for dtype, (atol, rtol) in ((torch.float32, (2e-5, 0)), (torch.bfloat16, (2e-2, 1e-2))):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        before = dict(fl.LAUNCHES)
        out = fl.flash_attention(*leaves, mask, causal=causal)
        grads = torch.autograd.grad(out, leaves, g.to(dtype))
        assert fl.LAUNCHES == {key: n_ + 1 for key, n_ in before.items()}
        x = [t.detach() for t in leaves]
        want, want_lse = fl.flash_fwd_reference(*x, mask, d ** -0.5, causal)
        _, lse = fl._flash_fwd_cuda(*x, mask, d ** -0.5, causal)
        torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
        want_b = fl.flash_bwd_reference(*x, mask, out.detach(), lse, g.to(dtype), d ** -0.5,
                                        causal)
        for a, w in zip(grads, want_b):
            torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol)
