"""Kernel K1 (fused short-sequence attention) of the PyTorch port against
the JAX package's Pallas kernel, run in interpreter mode on the CPU.

On the CPU the port's wrapper takes its plain version, so these tests hold
that version to the Pallas kernel's function; the CUDA kernel is held to the
plain version on the card (the ``cuda`` test below, and ``chip_smoke.py``).
Inputs are made from a seed with numpy and fed to both packages in f32.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.ops.fused_attention import fused_mha_interpret
from mmlearn_tpu.ops.fused_attention import interleave_qkv_heads as jax_interleave
from mmlearn_tpu.ops.fused_attention import supports_fused as jax_supports_fused
from mmlearn_tpu_torch import _build, profile_step
from mmlearn_tpu_torch.ops import fused_attention as fa

# the JAX package's own tolerance for this kernel against its reference
# (tests/ops/test_fused_attention.py:83): f32 sums in another order
ATOL = 2e-5


def _qkv(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)


def _mask(kind, b, n, seed):
    if kind == "none":
        return None
    rng = np.random.default_rng(seed + 100)
    mask = rng.random((b, n)) > 0.3
    if kind == "random":
        mask[:, 0] = True
    elif kind == "all_masked":  # rows whose every visible key is masked
        mask[0, : n // 3] = False  # left padding: early causal rows see none
        mask[1] = False  # a sample with no valid key at all
    else:
        mask[:] = True
        if kind == "right_pad":
            mask[0, n // 2:] = False
        elif kind == "left_pad":  # early causal rows see no key
            mask[0, : n // 3] = False
        else:  # "empty_sample"
            mask[1] = False
    return mask


@pytest.mark.parametrize("mask_kind", ["none", "random", "all_masked", "right_pad", "left_pad",
                                       "empty_sample"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 80, 88])
@pytest.mark.parametrize("n", [77, 197])
def test_plain_matches_pallas_interpret(n, d, causal, mask_kind):
    b, h = 2, 2
    qkv = _qkv(b, n, h, d, seed=n + d)
    mask = _mask(mask_kind, b, n, seed=n)
    want = fused_mha_interpret(
        jnp.asarray(qkv), None if mask is None else jnp.asarray(mask),
        num_heads=h, causal=causal,
    )
    got = fa.fused_mha(
        torch.from_numpy(qkv), None if mask is None else torch.from_numpy(mask),
        num_heads=h, causal=causal,
    )
    assert got.shape == (b, n, h * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fully_masked_row_averages_all_values():
    """The finite mask value: a row with no visible key is the mean of V
    over every key, not NaN."""
    b, n, h, d = 1, 9, 1, 32
    qkv = _qkv(b, n, h, d, seed=3)
    mask = np.zeros((b, n), bool)
    got = fa.fused_mha(torch.from_numpy(qkv), torch.from_numpy(mask), num_heads=h)
    v = qkv.reshape(b, n, h, 3, d)[..., 2, :].mean(axis=1)  # (b, h, d)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(v.reshape(b, 1, h * d),
                                                            (b, n, h * d)), atol=1e-6)


@pytest.mark.parametrize(
    "shape", [(16, 48), (48,), (3, 16, 48)], ids=["kernel", "bias", "stacked"]
)
def test_interleave_matches_jax_and_round_trips(shape):
    h = 4
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_interleave(x, h))
    np.testing.assert_array_equal(fa.interleave_qkv_heads(x, h), want)
    np.testing.assert_array_equal(
        fa.interleave_qkv_heads(torch.from_numpy(x), h).numpy(), want
    )
    np.testing.assert_array_equal(fa.uninterleave_qkv_heads(want, h), x)
    np.testing.assert_array_equal(
        fa.uninterleave_qkv_heads(torch.from_numpy(want), h).numpy(), x
    )


@pytest.mark.parametrize(
    "heads,head_dim,seq",
    [(12, 64, 197), (8, 64, 77), (12, 32, 197), (8, 32, 77), (16, 80, 257), (16, 88, 197)],
)
def test_supports_fused_matches_jax_at_slice_shapes(heads, head_dim, seq):
    assert fa.supports_fused(heads, head_dim, seq)
    assert jax_supports_fused(heads, head_dim, seq)


def test_supports_fused_rule():
    # the JAX package's byte model: one head group's backward within 20 MiB
    assert fa.supports_fused(2, 64, 768)
    assert not fa.supports_fused(2, 64, 769)  # long sequences: flash kernel
    assert fa.supports_fused(4, 32, 512)
    assert not fa.supports_fused(4, 32, 513)
    assert not fa.supports_fused(2, 64, 2049)
    assert not fa.supports_fused(3, 64, 197)  # heads not a multiple of 2
    assert not fa.supports_fused(6, 32, 197)  # heads not a multiple of 4


@pytest.mark.parametrize("heads,head_dim,limit", [(8, 80, 336), (16, 80, 336), (16, 88, 208)])
def test_supports_fused_matches_jax_around_the_large_presets_limits(heads, head_dim, limit):
    """vit_huge's D=80 (heads in groups of 8) and vit_giant's D=88 (groups of
    16): the JAX predicate's outcome at each length around its limit, and at
    heads that are not a whole group."""
    for n in (limit - 1, limit, limit + 1, 257):
        assert fa.supports_fused(heads, head_dim, n) == jax_supports_fused(heads, head_dim, n)
    assert fa.supports_fused(heads, head_dim, limit)
    assert not fa.supports_fused(heads, head_dim, limit + 1)
    assert not fa.supports_fused(heads + 4, head_dim, 197)
    assert not jax_supports_fused(heads + 4, head_dim, 197)


def test_wrapper_takes_plain_version_only_on_cpu():
    qkv = torch.from_numpy(_qkv(1, 5, 2, 32, seed=0))
    want = fa.mha_reference(qkv, None, 2, 32 ** -0.5, False)
    torch.testing.assert_close(fa.fused_mha(qkv, num_heads=2), want, rtol=0, atol=0)
    before = fa.LAUNCHES["fused_mha_fwd"]
    fa.fused_mha(qkv, num_heads=2)
    assert fa.LAUNCHES["fused_mha_fwd"] == before  # no kernel ran
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.fused_mha(torch.empty(1, 5, 192, device="meta"), num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("d", [32, 64, 80, 88])
def test_cuda_kernel_matches_plain(d, causal, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++ for sm_90a)")
    # heads in whole groups of supports_fused: 4 at D=32 and 64, 8 at 80, 16 at 88
    b, n, h = 4, 197, {80: 8, 88: 16}.get(d, 4)
    qkv = torch.from_numpy(_qkv(b, n, h, d, seed=d)).cuda()
    mask = torch.from_numpy(_mask("random", b, n, 1)).cuda() if masked else None
    for dtype, (atol, rtol) in ((torch.float32, (2e-5, 0)), (torch.bfloat16, (2e-2, 1e-2))):
        x = qkv.to(dtype)
        before = fa.LAUNCHES["fused_mha_fwd"]
        got = fa.fused_mha(x, mask, num_heads=h, causal=causal)
        assert fa.LAUNCHES["fused_mha_fwd"] == before + 1
        want = fa.mha_reference(x, mask, h, d ** -0.5, causal)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# the shared header each attention source includes: K1's mma.sync helpers,
# K3's wgmma, TMA and mbarrier helpers
_SHARED_HEADER = {"fused_attention": "attention_tiles.cuh", "flash_attention": "hopper_tiles.cuh"}


@pytest.mark.parametrize("source", ["fused_attention", "flash_attention"])
def test_library_path_follows_the_shared_header(tmp_path, monkeypatch, source):
    """Each attention source includes a shared header (``_SHARED_HEADER``):
    an edit of the header moves its built library, on a copy of ``csrc``; the
    same files keep their path, and an edit of one source moves only its
    own."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    name = _SHARED_HEADER[source]
    assert f'#include "{name}"' in (csrc / f"{source}.cu").read_text()
    before = _build.library_path(source)
    assert _build.library_path(source) == before
    other = "int8_matmul"
    other_before = _build.library_path(other)
    header = csrc / name
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(source)
    assert after != before and after.startswith(_build.BUILD_DIR)
    with open(csrc / f"{source}.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path(source) != after
    assert _build.library_path(other) != other_before  # every header is in every key


def _kernel_names(source: str) -> list[str]:
    with open(f"{_build.CSRC_DIR}/{source}.cu") as f:
        return re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", f.read())


@pytest.mark.parametrize("source,groups", [
    ("fused_attention", {"K1f attention forward", "K1b attention backward"}),
    ("fused_attention_packed", {"K1f-p attention forward, head-grouped",
                                "K1b-p attention backward, head-grouped"}),
    ("flash_attention", {"K3f flash attention forward", "K3b flash attention backward"}),
])
def test_profile_groups_name_every_attention_kernel(source, groups):
    """``profile_step`` attributes each attention kernel's device time by its
    name: every kernel of the source falls in its own forward or backward
    group, as the profiler prints it (a template instance in the anonymous
    namespace)."""
    names = _kernel_names(source)
    assert names
    got = {name: profile_step._group(f"void (anonymous namespace)::{name}<64>(int)")
           for name in names}
    assert set(got.values()) == groups, got
    for name, group in got.items():
        assert ("forward" in group) == ("fwd" in name), (name, group)
