"""The head-grouped small-head-dim attention of the PyTorch port (K1f-p /
K1b-p, the port of the TPU's lane-packed ``_fwd_kernel_packed`` /
``_bwd_kernel_packed``) against the JAX package on the CPU.

The packed kernels compute K1's function, so the port's ``fused_mha`` on a
CPU tensor (its plain versions) is held against the JAX package's packed
Pallas bodies in interpret mode, with ``MMLEARN_FUSED_ATTN_PACKED=1`` set
as the JAX package's own tests set it, at those tests' tolerances (atol
2e-5 forward, 3e-5 backward; f32). The port's dispatch predicate is held to
``_packed_enabled`` and ``_head_group``, and the host side of the kernels --
the forward's plan of shared memory by length, the backward's scratch, the
ctypes bindings -- to the CUDA source. The CUDA kernels themselves run only
on a card (the ``cuda`` tests below, and ``chip_smoke.py``). Inputs are made
from a seed with numpy.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mmlearn_tpu.ops import fused_attention as jfa
from mmlearn_tpu_torch import _build
from mmlearn_tpu_torch.ops import fused_attention as fa

_PACKED_SOURCE = os.path.join(_build.CSRC_DIR, "fused_attention_packed.cu")


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
    """The head-grouped kernels count as K1 does: a forward, and a backward
    of two launches (p and ds, then the products; f32: dQ, then dK/dV)."""
    assert {"fused_mha_packed_fwd", "fused_mha_packed_bwd"} <= set(fa.LAUNCHES)
    assert not [k for k in fa.LAUNCHES if k.startswith("fused_mha_packed_bwd_")]


def _admitted(d):
    return range(1, fa._PACKED_MAX_SEQ[d] + 1)


def _smem(seq, d, warps, stages):
    """Shared memory of a K1f-p block as the CUDA source lays it out."""
    rows = -(-seq // 32) * 32
    return stages * rows * (2 * (2 * d + 8) + 1) + warps * 16 * (d + 8) * 2 + 8 * 16 + 16


@pytest.mark.parametrize("d", [32, 64])
def test_packed_fwd_plan_fits_every_admitted_length(d):
    """At every length that ``use_packed`` admits, K1f-p's block has a ring
    of 1-8 head buffers and fits the 227 KB a block may use, with as many
    buffers as fit."""
    for seq in _admitted(d):
        warps, stages = fa.packed_fwd_plan(seq, d)
        whole_rows = 16 if d == 32 and seq <= 128 else 12
        assert warps == (whole_rows if seq <= 224 else 8), seq
        assert 1 <= stages <= 8, seq
        assert _smem(seq, d, warps, stages) <= 232_448, seq
        if stages < 8:
            assert _smem(seq, d, warps, stages + 1) > 232_448, seq


def test_packed_fwd_plan_prefetches_at_the_ijepa_lengths():
    """The I-JEPA step's attention (teacher 196 and student 84 at D=64, the
    predictor's 118 at D=32) gets at least two head buffers, so the next
    head's K and V load while one computes; one is left only past 384 keys
    at D=64."""
    for seq, d in ((196, 64), (84, 64), (118, 32)):
        assert fa.packed_fwd_plan(seq, d)[1] >= 2
    assert [seq for seq in _admitted(64) if fa.packed_fwd_plan(seq, 64)[1] == 1] == \
        list(range(385, 769))
    assert min(fa.packed_fwd_plan(seq, 32)[1] for seq in _admitted(32)) == 2


@pytest.mark.parametrize("d", [32, 64])
def test_chip_smoke_checks_where_the_packed_plan_switches(d):
    """``chip_smoke.py`` holds the kernels on the card on both sides of every
    length where K1f-p's plan changes (warps or buffers), and at the longest
    admitted length."""
    checked = {n for n, hd in chip_smoke.PACKED_LENGTHS if hd == d}
    plans = [fa.packed_fwd_plan(seq, d) for seq in _admitted(d)]
    switches = [seq for seq, a, b in zip(_admitted(d), plans, plans[1:]) if a != b]
    assert switches
    for seq in switches:
        assert {seq, seq + 1} <= checked, seq
    assert fa._PACKED_MAX_SEQ[d] in checked


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, (2 * 3 * 12 * 128 * 128, torch.bfloat16)),
    (torch.float32, (3 * 3 * 12 * 118, torch.float32)),
])
def test_backward_scratch(dtype, want):
    """K1b and K1b-p share the scratch: in bf16 the p and ds planes (nq =
    118 rounded up to 16 = 128), in f32 each row's max, sum and delta."""
    assert fa._bwd_scratch(3, 118, 12, dtype) == want


def _c_params(source, name):
    with open(source) as f:
        text = f.read()
    match = re.search(rf"int {name}\(([^)]*)\)", text)
    assert match, name
    return [p.strip() for p in match.group(1).split(",")]


@pytest.mark.parametrize("packed", [False, True], ids=["k1", "k1p"])
def test_bindings_match_the_c_entry_points(packed):
    """The ctypes argument lists of both libraries' entry points have the C
    prototypes' length, with ``c_void_p`` exactly where C takes a pointer
    (ctypes would cut a pointer to 32 bits) -- K1f-p takes the ring's
    buffers before the stream."""
    name, fwd, bwd = fa._SOURCES[packed][:3]
    source = os.path.join(_build.CSRC_DIR, f"{name}.cu")
    fwd_types = fa._PACKED_FWD_ARGTYPES if packed else fa._FWD_ARGTYPES
    for entry, types in ((fwd, fwd_types), (bwd, fa._BWD_ARGTYPES)):
        params = _c_params(source, entry)
        assert len(params) == len(types), entry
        for param, ctype in zip(params, types):
            assert ("*" in param) == (ctype is ctypes.c_void_p), (entry, param)
    if packed:
        assert _c_params(source, fwd)[-2] == "int stages"


def test_packed_plan_constants_match_the_source():
    with open(_PACKED_SOURCE) as f:
        text = f.read()
    assert re.search(r"constexpr int kMaxStages = (\d+);", text).group(1) == \
        str(fa._PACKED_MAX_STAGES)
    assert "kMaxStages * (8 + 4 + 4) + 16" in text
    assert "kv_rows(n) * (2 * (2 * D + 8) + 1)" in text


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(32, 118), (64, 84), (64, 196), (32, 512), (64, 768)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(32, 118), (64, 84), (64, 196)])
@pytest.mark.parametrize("mask_kind", [None, "keys"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cuda_packed_bf16_is_k1_bit_for_bit(d, n, mask_kind, causal, monkeypatch):
    """In bf16 the head-grouped kernels compute K1's bits: K1f-p's output and
    K1b-p's dqkv equal K1f's and K1b's on the same input exactly (atol 0,
    rtol 0), and so sit within K1's limits of the plain versions (those
    limits cover the tensor cores' sums, which round elsewhere than the plain
    f32 einsums: ``chip_smoke.py`` K1f atol 1.3e-2, K1b 4e-7, rtol 2^-7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the head-grouped kernels are CUDA C++)")
    h = 12
    qkv, dout, mask = (torch.from_numpy(a).cuda() for a in _data(3, n, h, d, seed=3 * d + n))
    qkv, dout = qkv.bfloat16(), dout.bfloat16()
    mask = mask if mask_kind else None
    got = {}
    for env in ("1", "0"):
        monkeypatch.setenv("MMLEARN_FUSED_ATTN_PACKED", env)
        x = qkv.clone().requires_grad_()
        out = fa.fused_mha(x, mask, num_heads=h, causal=causal)
        (g,) = torch.autograd.grad(out, x, dout)
        got[env] = (out.detach(), g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got["1"], got["0"], rtol=0, atol=0)
    scale = d ** -0.5
    out, g = got["1"]
    torch.testing.assert_close(out.float(), fa.mha_reference(qkv, mask, h, scale, causal).float(),
                               rtol=2 ** -7, atol=1.3e-2)
    torch.testing.assert_close(
        g.float(),
        fa.mha_bwd_reference(qkv, mask, out, dout, h, scale, causal).float(),
        rtol=2 ** -7, atol=4e-7)
