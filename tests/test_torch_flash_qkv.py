"""K3 on the head-major packed projection: the port's ``flash_attention_qkv``
(``FlashQKVFunction``) against ``jax.vjp`` of the JAX package's flash branch
(``mmlearn_tpu/modules/layers/attention.py:135-145``: reshape, transposes,
``flash_attention``, heads merged), and ``Attention``'s flash branch through
it against the same attention through ``flash_attention`` on the split views.

On the CPU the Function runs the plain versions on the three strided views
and lands dq, dk, dv in one ``(B, N, H, 3, D)`` buffer, the layout in which
K3b writes them on the card (the ``cuda`` test below, and ``chip_smoke.py``).
Inputs are made from a seed with numpy and fed to both packages in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.ops import flash_attention as fl

# the port's plain backward against autodiff of the same f32 math: the
# softmax's delta taken as sum(dout * out) instead of sum(p * dp), as in
# tests/test_torch_flash_attention.py
VJP_ATOL = 2e-5


def _mask(kind, b, n):
    """None; a ragged key mask (random keys, key 0 visible); sample 1 wholly
    masked."""
    if kind == "none":
        return None
    mask = np.ones((b, n), bool)
    if kind == "ragged":
        mask = np.random.default_rng(3).random((b, n)) > 0.3
        mask[:, 0] = True
    else:  # "empty_sample"
        mask[1] = False
    return mask


def _jax_flash_branch(qkv, mask, h, causal):
    """The JAX package's flash branch of ``Attention.__call__``."""
    b, n, three_c = qkv.shape
    d = three_c // (3 * h)
    hm = qkv.reshape(b, n, h, 3, d)
    q, k, v = (jnp.transpose(hm[..., i, :], (0, 2, 1, 3)) for i in range(3))
    out = jax_flash_attention(q, k, v, mask=mask, scale=d ** -0.5, causal=causal)
    return jnp.transpose(out, (0, 2, 1, 3)).reshape(b, n, h * d)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "ragged", "empty_sample"])
def test_flash_qkv_matches_jax_vjp(mask_kind, causal, d):
    """Output and dqkv against ``jax.vjp`` of the JAX flash branch: atol 2e-5
    (rows that see no key included: dq = 0 there, dv gets dout / N)."""
    b, h, n = 2, 2, 37
    rng = np.random.default_rng(d + 2 * causal)
    qkv = rng.standard_normal((b, n, h * 3 * d)).astype(np.float32)
    g = rng.standard_normal((b, n, h * d)).astype(np.float32)
    mask = _mask(mask_kind, b, n)
    jm = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda x: _jax_flash_branch(x, jm, h, causal), jnp.asarray(qkv))
    (want_dqkv,) = vjp(jnp.asarray(g))

    x = torch.from_numpy(qkv).requires_grad_()
    out = fl.flash_attention_qkv(x, None if mask is None else torch.from_numpy(mask),
                                 num_heads=h, causal=causal)
    out.backward(torch.from_numpy(g))
    assert out.shape == (b, n, h * d) and x.grad.shape == x.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=VJP_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dqkv), atol=VJP_ATOL)


def _split_route(attn, x, mask):
    """The flash branch through ``flash_attention``: the three views, heads
    merged by a transpose and a reshape, the gradients stacked by autograd."""
    b, n, c = x.shape
    q, k, v = attn.qkv(x).view(b, n, attn.num_heads, 3, -1).permute(3, 0, 2, 1, 4).unbind(0)
    out = fl.flash_attention(q, k, v, mask, scale=attn.scale, causal=attn.causal)
    return attn.proj(out.transpose(1, 2).reshape(b, n, c))


@pytest.mark.parametrize("causal,mask_kind", [(False, "none"), (False, "empty_sample"),
                                              (True, "ragged")])
def test_attention_flash_branch_equals_split_route(causal, mask_kind):
    """``Attention`` past ``supports_fused`` (N = 520 at D = 32) through
    ``FlashQKVFunction``, and through ``flash_attention`` on the split views,
    on the same weights and input: equal output, input gradient and parameter
    gradients (tolerance 0: the same plain versions, only the layout of dqkv
    differs)."""
    torch.manual_seed(0)
    b, n, h, d = 2, 520, 2, 32
    attn = Attention(h * d, num_heads=h, qkv_bias=True, causal=causal)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, n, h * d)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, n, h * d)).astype(np.float32))
    mask = _mask(mask_kind, b, n)
    mask = None if mask is None else torch.from_numpy(mask)
    results = []
    for route in (lambda xx: attn(xx, mask), lambda xx: _split_route(attn, xx, mask)):
        attn.zero_grad()
        xx = x.clone().requires_grad_()
        out = route(xx)
        out.backward(g)
        results.append([out.detach(), xx.grad] + [p.grad.clone() for p in attn.parameters()])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_qkv_rejects_bad_shapes_and_devices():
    qkv = torch.zeros(1, 5, 2 * 3 * 32)
    with pytest.raises(ValueError, match="qkv must be"):
        fl.flash_attention_qkv(qkv, num_heads=5)
    with pytest.raises(ValueError, match="mask"):
        fl.flash_attention_qkv(qkv, torch.ones(1, 1, 5, dtype=torch.bool), num_heads=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fl.flash_attention_qkv(torch.empty(1, 5, 192, device="meta"), num_heads=2)
    before = dict(fl.LAUNCHES)
    fl.flash_attention_qkv(qkv.requires_grad_(), num_heads=2).sum().backward()
    assert fl.LAUNCHES == before


# ----------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("causal,mask_kind", [(False, "none"), (False, "ragged"),
                                              (False, "empty_sample"), (True, "none")])
@pytest.mark.parametrize("d", [32, 64])
def test_cuda_flash_qkv_matches_plain(d, causal, mask_kind):
    """K3f and K3b in the main path's layout (strided reads of a packed bf16
    projection, dqkv written in place) against the plain versions on the same
    views: 2e-2 + 1e-2 relative, as the split-layout test; one launch of each
    kernel a forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    b, h, n = 2, 3, 200
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(rng.standard_normal((b, n, h * 3 * d)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, n, h * d)).astype(np.float32))
    qkv, g = qkv.cuda().bfloat16(), g.cuda().bfloat16()
    mask = _mask(mask_kind, b, n)
    mask = None if mask is None else torch.from_numpy(mask).cuda()
    x = qkv.clone().requires_grad_()
    before = dict(fl.LAUNCHES)
    out = fl.flash_attention_qkv(x, mask, num_heads=h, causal=causal)
    out.backward(g)
    assert fl.LAUNCHES == {key: c + 1 for key, c in before.items()}
    q, k, v = fl.split_qkv(qkv, h)
    want, lse = fl.flash_fwd_reference(q, k, v, mask, d ** -0.5, causal)
    torch.testing.assert_close(out.float(), want.transpose(1, 2).reshape(b, n, -1).float(),
                               atol=2e-2, rtol=1e-2)
    _, got_lse = fl._flash_fwd_cuda(q, k, v, mask, d ** -0.5, causal)
    got_out = out.detach().view(b, n, h, d).transpose(1, 2)
    want_grads = fl.flash_bwd_reference(q, k, v, mask, got_out, got_lse,
                                        g.view(b, n, h, d).transpose(1, 2), d ** -0.5, causal)
    want_dqkv = torch.stack(want_grads, 2).permute(0, 3, 1, 2, 4).reshape(b, n, -1)
    torch.testing.assert_close(x.grad.float(), want_dqkv.float(), atol=2e-2, rtol=1e-2)
