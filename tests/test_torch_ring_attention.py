"""The port's ring attention (``mmlearn_tpu_torch.ops.ring_attention``) on
the CPU, in one process through the list exchange (P ranks' hops on one
device), against the JAX ``sequence_sharded_attention`` on
``create_mesh(seq=P)`` over the 8 virtual CPU devices: outputs at atol 2e-5
and the gradients of ``sum(out * cos(out))`` at atol 3e-5
(``tests/ops/test_ring_attention.py``), f32, P = 2, 4 and 8, causal and not,
head dim 16 and 128; bf16 against the JAX ring with its flash block backend
in interpret mode (``:140``'s tolerance, one bf16 ulp of the output); the
attention
layer and a ViT tower on a ``seq`` group against
``tests/modules/test_seq_parallel_attention.py``'s cases and tolerances;
the merge's dead rows; the hops the exchange counts. The JAX references are
jitted once a configuration (outputs and gradients together)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.modules.encoders.vision import VisionTransformer as JVision
from mmlearn_tpu.modules.layers.attention import Attention as JAttention
from mmlearn_tpu.ops.ring_attention import _NEG as jax_neg
from mmlearn_tpu.ops.ring_attention import _block_attn_flash
from mmlearn_tpu.ops.ring_attention import _merge as jax_merge
from mmlearn_tpu.ops.ring_attention import sequence_sharded_attention as jax_ring
from mmlearn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from mmlearn_tpu.parallel.mesh import set_global_mesh as jax_set_global_mesh
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import VisionTransformer
from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.ops.ring_attention import (
    NEG,
    ListExchange,
    _merge,
    ring_attention_blocks,
    sequence_sharded_attention,
)
from mmlearn_tpu_torch.parallel.mesh import emulated_seq_mesh, set_global_mesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models on one intra-op thread: under a parallel test run,
    several workers' thread pools on the same cores slow them many times
    over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def qkv(b, h, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))


def jax_reference(q, k, v, seq: int):
    """The JAX ring's outputs and the gradients of ``sum(out cos(out))``,
    non-causal then causal, from one jitted function."""
    mesh = jax_create_mesh(data=1, fsdp=1, seq=seq, model=1)

    def both(q, k, v):
        res = []
        for causal in (False, True):
            def loss(q, k, v, causal=causal):
                out = jax_ring(q, k, v, mesh, causal=causal)
                return jnp.sum(out * jnp.cos(out)), out

            (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            res.append((out, grads))
        return res

    return jax.device_get(jax.jit(both)(q, k, v))


def port_ring(q, k, v, seq: int, causal: bool):
    ex = ListExchange(seq)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = sequence_sharded_attention(*leaves, ex, causal=causal)
    (out * torch.cos(out)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves], ex


@pytest.mark.parametrize("seq,d", [(2, 16), (4, 16), (8, 16), (4, 128)])
def test_ring_matches_jax(seq, d):
    """Outputs (atol 2e-5) and gradients (atol 3e-5) against the JAX ring at
    b 2, h 4, n 64; causal and not."""
    q, k, v = qkv(2, 4, 64, d, seed=seq + d)
    for causal, (want, want_grads) in zip((False, True), jax_reference(q, k, v, seq)):
        got, grads, _ = port_ring(q, k, v, seq, causal)
        np.testing.assert_allclose(got, want, atol=2e-5)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g, w, atol=3e-5)


def jax_flash_ring(q, k, v, seq: int):
    """The JAX ring's forward with the flash block backend (the hop that
    ``MMLEARN_RING_FLASH_INTERPRET=1`` selects: ``_block_attn_flash``, the
    Pallas kernel in interpret mode, f32 output) and its ``_merge``, rank by
    rank as ``_ring_fwd_loop`` runs them, non-causal; the output in q's
    type. Without ``shard_map``, whose interpret-mode compile takes seconds
    a configuration."""
    n = q.shape[2] // seq
    block = [slice(r * n, (r + 1) * n) for r in range(seq)]
    # one compile of the hop and of the merge, run P^2 times
    hop = jax.jit(functools.partial(_block_attn_flash, scale=q.shape[-1] ** -0.5,
                                    interpret=True))
    merge = jax.jit(jax_merge)
    outs = []
    for idx in range(seq):
        qi = q[:, :, block[idx]]
        acc = jnp.zeros(qi.shape, jnp.float32)
        lse = jnp.full(qi.shape[:3] + (1,), jax_neg, jnp.float32)
        for step in range(seq):
            src = (idx - step) % seq
            o, l = hop(qi, k[:, :, block[src]], v[:, :, block[src]])
            acc, lse = merge(acc, lse, o, l)
        outs.append(acc.astype(q.dtype))
    return np.asarray(jnp.concatenate(outs, axis=2), np.float32)


def test_ring_bf16_matches_the_jax_flash_backend():
    """bf16 inputs at ``:140``'s case (b 2, h 2, n 128, d 16, P=8),
    non-causal: the port's ring against the JAX ring with its flash block
    backend, to one bf16 ulp of the output (rtol 1e-2, atol 1e-3, ``:140``'s)."""
    q, k, v = qkv(2, 2, 128, 16, seed=5)
    want = jax_flash_ring(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 8)
    got = sequence_sharded_attention(*(torch.tensor(x).bfloat16() for x in (q, k, v)),
                                     ListExchange(8))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("seq", [2, 4, 8])
def test_hops_computed_and_skipped(seq):
    """A pass computes P^2 hops, or P (P + 1) / 2 under a causal mask (the
    later hops skipped), forward and backward alike."""
    q, k, v = qkv(1, 1, 8 * seq, 8, seed=1)
    for causal in (False, True):
        _, _, ex = port_ring(q, k, v, seq, causal)
        done = seq * (seq + 1) // 2 if causal else seq * seq
        assert ex.hops == {"forward": done, "backward": done, "skipped": 2 * (seq * seq - done)}


def test_runs_are_bit_equal():
    """The hop sums run in one fixed order: a second run gives the same
    bits."""
    q, k, v = qkv(2, 2, 32, 16, seed=2)
    first, second = (port_ring(q, k, v, 4, True) for _ in range(2))
    np.testing.assert_array_equal(first[0], second[0])
    for a, b in zip(first[1], second[1]):
        np.testing.assert_array_equal(a, b)


def test_merge_keeps_dead_rows_dead():
    """Rows whose log-sum-exps are both ``NEG`` (no key seen) keep ``NEG``
    and take nothing; a live hop into a dead running pair is taken whole."""
    acc = torch.zeros(1, 1, 2, 3)
    dead = torch.full((1, 1, 2, 1), NEG)
    o = torch.ones(1, 1, 2, 3)
    out, lse = _merge(acc, dead, o, dead.clone())
    assert torch.equal(out, acc) and torch.equal(lse, dead)
    live = torch.tensor([[[[0.5], [NEG]]]])
    out, lse = _merge(acc, dead, o, live)
    assert torch.equal(out[0, 0, 0], o[0, 0, 0]) and torch.equal(out[0, 0, 1], acc[0, 0, 1])
    assert lse[0, 0, 0, 0] == 0.5 and lse[0, 0, 1, 0] == NEG


def test_blocks_of_other_shapes_raise():
    """Blocks of different shapes raise before any hop."""
    q, k, v = (torch.zeros(1, 1, 8, 4) for _ in range(3))
    with pytest.raises(ValueError, match="one shape"):
        ring_attention_blocks([q], [k[:, :, :4]], [v], 0.5, False, ListExchange(1))


@pytest.fixture
def clear_meshes():
    yield
    jax_set_global_mesh(None)
    set_global_mesh(None)


def jax_params(module) -> dict:
    """A port module's weights as the JAX module's ``{"params": tree}``
    (flax's eager ``init`` compiles for seconds)."""
    tree: dict = {}
    for path, arr in bridge.torch_to_jax(module).items():
        *heads, leaf = path.split("/")
        node = tree
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr)
    return {"params": tree}


def _attention_pair(x):
    torch.manual_seed(0)
    attn = Attention(x.shape[-1], num_heads=4, qkv_bias=True)
    return JAttention(num_heads=4, qkv_bias=True), jax_params(attn), attn


def test_attention_layer_on_a_seq_group(clear_meshes):
    """The layer on a ``seq`` group of 8 against the JAX layer on its seq
    mesh (atol 2e-5); 13 tokens do not divide the ring: the existing branch
    serves them, against the JAX layer's (2e-5)."""
    x = np.random.default_rng(0).standard_normal((2, 32, 64)).astype(np.float32)
    jattn, params, attn = _attention_pair(x)
    jax_set_global_mesh(jax_create_mesh(data=1, fsdp=1, seq=8, model=1))
    want = np.asarray(jax.jit(functools.partial(jattn.apply, params))(jnp.asarray(x)))
    set_global_mesh(emulated_seq_mesh(8))
    with torch.no_grad():
        got = attn(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)

    x13 = np.random.default_rng(2).standard_normal((2, 13, 64)).astype(np.float32)
    jattn, params, attn = _attention_pair(x13)
    want = np.asarray(jax.jit(jattn.apply)(params, jnp.asarray(x13)))
    mesh = emulated_seq_mesh(8)
    set_global_mesh(mesh)
    with torch.no_grad():
        got = attn(torch.tensor(x13)).numpy()
    assert mesh.seq_exchange().hops["forward"] == 0  # not through the ring
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_vit_forward_and_grads_on_a_seq_group(clear_meshes):
    """A ViT tower of 16 patches without a cls token on a ``seq`` group of 4
    against the JAX tower on its ``data=2, seq=4`` mesh: the loss (rtol
    1e-5) and every gradient (atol 5e-5, rtol 1e-4)."""
    kw = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=4,
              use_cls_token=False, global_pool="avg", proj_dim=16)
    vit = JVision(**kw)
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(np.float32)
    tower = VisionTransformer(**kw, generator=torch.Generator().manual_seed(0))
    params = jax_params(tower)

    def loss(p, x):
        return jnp.sum(jnp.square(vit.apply(p, x).pooler_output))

    jax_set_global_mesh(jax_create_mesh(data=2, fsdp=1, seq=4, model=1))
    l_want, g_want = jax.device_get(jax.jit(jax.value_and_grad(loss))(params, jnp.asarray(x)))
    mesh = emulated_seq_mesh(4)
    set_global_mesh(mesh)
    l_got = tower(torch.tensor(x)).pooler_output.square().sum()
    l_got.backward()
    assert mesh.seq_exchange().hops["forward"] == 2 * 16  # 2 blocks, P^2 hops each
    np.testing.assert_allclose(float(l_got.detach()), float(l_want), rtol=1e-5)
    want = bridge.jax_to_torch(g_want["params"])
    for name, p in tower.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-4,
                                   err_msg=name)
