"""Layers of the PyTorch port against their flax counterparts.

Each flax module is initialised by JAX, its parameters cross through
``mmlearn_tpu_torch.bridge`` into the port's module, and both run the same
numpy inputs in f32 on the CPU (the port's kernels take their plain
versions there). Tolerance: 1e-5 absolute, f32 sums in another order.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.modules.layers.attention import Attention as JAttention
from mmlearn_tpu.modules.layers.embedding import PatchEmbed as JPatchEmbed
from mmlearn_tpu.modules.layers.embedding import (
    get_2d_sincos_pos_embed as jax_sincos,
)
from mmlearn_tpu.modules.layers.mlp import MLP as JMLP
from mmlearn_tpu.modules.layers.normalization import FusedLayerNorm as JFusedLN
from mmlearn_tpu.modules.layers.normalization import l2_normalize as jax_l2
from mmlearn_tpu.modules.layers.transformer_block import Block as JBlock
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules import layers

ATOL = 1e-5


def _port(module, jax_module, *args):
    """Init ``jax_module`` on ``args``, load its params into ``module``."""
    params = jax_module.init(jax.random.key(0), *(jnp.asarray(a) for a in args))
    module.load_state_dict(bridge.jax_to_torch(jax.device_get(params["params"])))
    return module.eval(), params


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
def test_mlp(activation):
    x = _x(2, 5, 32)
    jm = JMLP(hidden_dims=[64], out_dim=24, activation=activation)
    pm, params = _port(layers.MLP(32, out_dim=24, hidden_dims=[64],
                                  activation=activation), jm, x)
    want = jm.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=ATOL)


def test_patch_embed_hwio_kernel():
    x = _x(2, 32, 32, 3)
    jm = JPatchEmbed(img_size=32, patch_size=8, embed_dim=48)
    pm, params = _port(layers.PatchEmbed(8, 3, 48), jm, x)
    want = jm.apply(params, jnp.asarray(x))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 16, 48)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_sincos_table_is_the_jax_table():
    np.testing.assert_array_equal(
        layers.get_2d_sincos_pos_embed(64, 4, cls_token=True),
        jax_sincos(64, 4, cls_token=True),
    )


# (dim, heads): D=64 takes the fused-kernel dispatch in both packages, D=8
# the JAX flash path -- the same function, which the port's plain version
# computes at any shape on the CPU
@pytest.mark.parametrize("dim,heads", [(128, 2), (32, 4)])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (True, True)])
def test_attention_head_major_qkv(dim, heads, causal, masked):
    x = _x(2, 13, dim)
    mask = np.ones((2, 13), bool)
    mask[1, 9:] = False
    jm = JAttention(num_heads=heads, qkv_bias=True, causal=causal)
    pm, params = _port(layers.Attention(dim, heads, qkv_bias=True, causal=causal), jm, x)
    m = mask if masked else None
    want = jm.apply(params, jnp.asarray(x), None if m is None else jnp.asarray(m))
    got = pm(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("act,causal", [("gelu", False), ("quick_gelu", True)])
def test_block(act, causal):
    x = _x(2, 11, 128, seed=1)
    mask = np.ones((2, 11), bool)
    mask[0, 7:] = False
    jm = JBlock(dim=128, num_heads=2, qkv_bias=True, act_layer=act, causal=causal,
                norm_eps=1e-5)
    pm, params = _port(layers.Block(128, 2, qkv_bias=True, act_layer=act,
                                    causal=causal, norm_eps=1e-5), jm, x, mask)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    got = pm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_fused_layernorm_both_call_forms():
    x, res = _x(2, 7, 64), _x(2, 7, 64, seed=2)
    jm = JFusedLN(epsilon=1e-6)
    # a non-trivial affine, given to both
    g, b = 1 + 0.1 * _x(64, seed=3), 0.1 * _x(64, seed=4)
    params = {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}}
    pm = layers.FusedLayerNorm(64, 1e-6)
    pm.load_state_dict(bridge.jax_to_torch(params["params"]))
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))), atol=ATOL)
    r_want, y_want = jm.apply(params, jnp.asarray(x), jnp.asarray(res))
    r_got, y_got = pm(torch.from_numpy(x), torch.from_numpy(res))
    np.testing.assert_allclose(r_got.detach().numpy(), np.asarray(r_want), atol=1e-6)
    np.testing.assert_allclose(y_got.detach().numpy(), np.asarray(y_want), atol=ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_layernorm_matches_flax(dtype):
    x = _x(3, 5, 48)
    jm = fnn.LayerNorm(epsilon=1e-5, dtype=dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pm, params = _port(layers.LayerNorm(48, 1e-5, dtype=tdtype), jm, x)
    want = np.asarray(jm.apply(params, jnp.asarray(x)).astype(jnp.float32))
    got = pm(torch.from_numpy(x))
    assert got.dtype == tdtype
    # bf16: one rounding of the same f32 value, up to an ulp apart
    atol = ATOL if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=atol)


def test_l2_normalize():
    x = _x(4, 16)
    x[2] = 0.0  # the eps floor keeps a zero row at zero
    np.testing.assert_allclose(layers.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2(jnp.asarray(x))), atol=1e-6)


def test_bridge_round_trip_keeps_jax_paths():
    """torch -> JAX paths -> torch is the identity, and the JAX paths are
    exactly the flax module's."""
    x = _x(2, 11, 128)
    jm = JBlock(dim=128, num_heads=2, qkv_bias=True)
    pm, params = _port(layers.Block(128, 2, qkv_bias=True), jm, x)
    flat = bridge.torch_to_jax(pm)
    assert sorted(flat) == sorted(bridge.flatten(jax.device_get(params["params"])))
    back = bridge.jax_to_torch(flat)
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
