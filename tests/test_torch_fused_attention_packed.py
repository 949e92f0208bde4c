"""The head-grouped small-head-dim attention of the PyTorch port (K1f-p /
K1b-p, the port of the TPU's lane-packed ``_fwd_kernel_packed`` /
``_bwd_kernel_packed``) against the JAX package on the CPU.

The packed kernels compute K1's function, so the port's ``fused_mha`` on a
CPU tensor (its plain versions) is held against the JAX package's packed
Pallas bodies in interpret mode, with ``MMLEARN_FUSED_ATTN_PACKED=1`` set
as the JAX package's own tests set it, at those tests' tolerances (atol
2e-5 forward, 3e-5 backward; f32). The port's dispatch predicate is held to
``_packed_enabled`` and ``_head_group``. The CUDA kernels themselves run only
on a card (the ``cuda`` test below, and ``chip_smoke.py``). Inputs are made
from a seed with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.ops import fused_attention as jfa
from mmlearn_tpu_torch.ops import fused_attention as fa


def _data(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    dout = rng.standard_normal((b, n, h * d)).astype(np.float32)
    mask = rng.random((b, n)) > 0.3
    mask[:, 0] = True
    return qkv, dout, mask


@pytest.mark.parametrize("h,d", [(4, 32), (4, 64)])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_forward_matches_packed_pallas_interpret(h, d, causal, monkeypatch):
    monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", "1")
    qkv, _, mask = _data(2, 29, h, d, seed=d + causal)
    # the packed body really runs (its head group is 128 / D in interpret mode)
    assert jfa._kernel_config(jnp.asarray(qkv), h, interpret=True)[3] == 128 // d
    want = jfa.fused_mha_interpret(jnp.asarray(qkv), jnp.asarray(mask), num_heads=h,
                                   causal=causal)
    got = fa.fused_mha(torch.from_numpy(qkv), torch.from_numpy(mask), num_heads=h,
                       causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("h,d", [(4, 32), (4, 64)])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradient_matches_packed_pallas_interpret(h, d, causal, monkeypatch):
    monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", "1")
    qkv, dout, mask = _data(2, 23, h, d, seed=11 + d + causal)
    want = jfa.fused_mha_bwd_interpret(jnp.asarray(qkv), jnp.asarray(dout),
                                       jnp.asarray(mask), num_heads=h, causal=causal)
    x = torch.from_numpy(qkv).requires_grad_()
    out = fa.fused_mha(x, torch.from_numpy(mask), num_heads=h, causal=causal)
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(dout))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("packed_env", ["1", "0", None], ids=["on", "off", "unset"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_dispatch_agrees_with_packed_enabled(d, packed_env, monkeypatch):
    """``use_packed`` routes a shape to the head-grouped kernels exactly
    where the JAX package runs its packed bodies: ``_packed_enabled`` and a
    head count that its head group (``_head_group``, 128 / D there) divides,
    read at call time from the environment."""
    if packed_env is None:
        monkeypatch.delenv("MMLEARN_FUSED_ATTN_PACKED", raising=False)
    else:
        monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", packed_env)
    for seq in (84, 118, 196, 360, 361, 512, 513, 768, 769):
        for heads in (2, 4, 6, 8, 12, 16):
            group = jfa._head_group(d)
            want = (jfa._packed_enabled(d, seq) and heads % group == 0
                    and group == 128 // d)
            assert fa.use_packed(heads, d, seq) == want, (heads, d, seq)
            assert fa._head_group(d) == group


def test_environment_is_read_at_call_time(monkeypatch):
    monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", "1")
    assert fa.use_packed(12, 32, 118)
    monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", "0")
    assert not fa.use_packed(12, 32, 118)


def test_cpu_path_ignores_the_variable(monkeypatch):
    """On a CPU tensor the plain versions run whatever the variable says,
    and no kernel launch is counted."""
    qkv, dout, mask = _data(2, 17, 4, 32, seed=5)
    results = []
    for env in ("0", "1"):
        monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", env)
        before = dict(fa.LAUNCHES)
        x = torch.from_numpy(qkv).requires_grad_()
        out = fa.fused_mha(x, torch.from_numpy(mask), num_heads=4)
        (g,) = torch.autograd.grad(out, x, torch.from_numpy(dout))
        assert fa.LAUNCHES == before
        results.append((out.detach(), g))
    torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)


def test_launch_counts_have_the_packed_keys():
    assert {"fused_mha_packed_fwd", "fused_mha_packed_bwd_dq",
            "fused_mha_packed_bwd_dkv"} <= set(fa.LAUNCHES)


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(32, 118), (64, 84), (64, 196)])
@pytest.mark.parametrize("mask_kind", [None, "keys"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cuda_packed_matches_plain(d, n, mask_kind, causal, monkeypatch):
    """The head-grouped kernels on the card against K1's plain versions, in
    f32 (sums in another order: atol 5e-6, chip_smoke.py's f32 limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the head-grouped kernels are CUDA C++)")
    monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", "1")
    h = 12
    qkv, dout, mask = (torch.from_numpy(a).cuda() for a in _data(3, n, h, d, seed=d + n))
    mask = mask if mask_kind else None
    before = fa.LAUNCHES["fused_mha_packed_fwd"]
    x = qkv.clone().requires_grad_()
    out = fa.fused_mha(x, mask, num_heads=h, causal=causal)
    (got,) = torch.autograd.grad(out, x, dout)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_mha_packed_fwd"] == before + 1
    scale = d ** -0.5
    torch.testing.assert_close(out, fa.mha_reference(qkv, mask, h, scale, causal),
                               rtol=0, atol=5e-6)
    torch.testing.assert_close(
        got, fa.mha_bwd_reference(qkv, mask, out.detach(), dout, h, scale, causal),
        rtol=0, atol=5e-6)
