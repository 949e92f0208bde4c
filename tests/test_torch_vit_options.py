"""The ViT layer and encoder options of the PyTorch port and its size presets,
against the JAX package on the CPU.

Each flax module is initialised by JAX, its parameters cross through
``mmlearn_tpu_torch.bridge``, and both run the same numpy inputs in f32
(the port's kernels take their plain versions here); heads have dim 80 or
88, the large presets' (``vit_huge``, ``vit_giant``). Dropout, attention
dropout, drop-path and patch dropout cannot draw alike across the two
packages' generators, so the masks and noise the JAX modules draw
(``jax.random.bernoulli``, ``jax.random.uniform``) are recorded in order and
replayed into the port through a :class:`Replay` mask source. Tolerances:
1e-5 on values; 2e-5 on gradients, absolute and relative (f32 sums in
another order, on gradients of ``sum(out * probe)`` up to about 10).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.encoders import vision as jvision
from mmlearn_tpu.modules.layers.embedding import ConvEmbed as JConvEmbed
from mmlearn_tpu.modules.layers.embedding import PatchEmbed as JPatchEmbed
from mmlearn_tpu.modules.layers.embedding import get_1d_sincos_pos_embed as jax_sincos_1d
from mmlearn_tpu.modules.layers.logit_scaling import LearnableLogitScaling as JScaling
from mmlearn_tpu.modules.layers.patch_dropout import PatchDropout as JPatchDropout
from mmlearn_tpu.modules.layers.transformer_block import Block as JBlock
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.trainer.flops import step_flops
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules import layers
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.encoders import vision as pvision
from mmlearn_tpu_torch.modules.layers.dropout import MaskSource, masks_from, step_source
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from mmlearn_tpu_torch.trainer import Trainer
from mmlearn_tpu_torch.trainer.flops import count_flops

ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-5, 2e-5


class Replay(MaskSource):
    """A mask source that hands out recorded draws in order, each checked
    against the shape asked for."""

    def __init__(self, draws) -> None:
        super().__init__(0, "cpu")
        self.draws = list(draws)

    def _next(self, kind, shape):
        got_kind, arr = self.draws.pop(0)
        assert got_kind == kind and tuple(arr.shape) == tuple(shape), (got_kind, arr.shape,
                                                                       kind, shape)
        return torch.from_numpy(np.array(arr))

    def keep(self, keep_prob, shape):
        return self._next("bernoulli", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)


class Draws(list):
    """The draws JAX made, ``[(kind, array), ...]``; inside :meth:`replayed`
    the patched functions return them again, in order, as constants (so a
    jitted JAX function applies the same masks)."""

    queue = None

    @contextlib.contextmanager
    def replayed(self):
        self.queue = list(self)
        try:
            yield
        finally:
            self.queue = None


@pytest.fixture
def recorded(monkeypatch):
    """Records the draws of ``jax.random.bernoulli`` and ``uniform`` while
    the test runs."""
    draws = Draws()

    def patched(kind, orig):
        def fn(*a, **k):
            if draws.queue is not None:
                got, arr = draws.queue.pop(0)
                assert got == kind
                return jnp.asarray(arr)
            out = orig(*a, **k)
            draws.append((kind, np.asarray(out)))
            return out
        return fn

    monkeypatch.setattr(jax.random, "bernoulli", patched("bernoulli", jax.random.bernoulli))
    monkeypatch.setattr(jax.random, "uniform", patched("uniform", jax.random.uniform))
    return draws


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _load(module, params):
    module.load_state_dict(bridge.jax_to_torch(jax.device_get(params)))
    return module


def _jax_value_and_grads(apply, params, x, probe, jit=False):
    """JAX's ``sum(out * probe)`` and its gradients in the params and x
    (compiled with ``jit``: where no draw is recorded)."""
    def f(p, xx):
        return jnp.sum(apply(p, xx) * probe)

    fn = jax.value_and_grad(f, argnums=(0, 1))
    return (jax.jit(fn) if jit else fn)(params, jnp.asarray(x))


def _assert_grads(module, jgrads, want_x, got_x):
    want = bridge.jax_to_torch(jax.device_get(jgrads["params"]))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


BLOCK_DROPS = {
    "drop": dict(drop=0.3),
    "attn_drop": dict(attn_drop=0.3),
    "drop_path": dict(drop_path_rate=0.5),
    "all": dict(drop=0.2, attn_drop=0.2, drop_path_rate=0.5),
}


@pytest.mark.parametrize("kind,d", [("drop", 80), ("attn_drop", 88), ("drop_path", 80),
                                    ("all", 88)])
def test_block_dropout_matches_jax_with_its_masks(recorded, kind, d):
    """Each dropout kind of ``Block`` (the projection's and the MLP's
    dropout, attention dropout on the materialized route, drop-path) with
    the masks the JAX block drew: the output, and the gradients in every
    parameter and the input."""
    b, n, h = 4, 9, 2
    rates = BLOCK_DROPS[kind]
    x = _x(b, n, h * d, seed=d)
    probe = jnp.asarray(_x(b, n, h * d, seed=1))
    jm = JBlock(dim=h * d, num_heads=h, causal=True, **rates)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    key = jax.random.key(7)

    def apply(p, xx):
        return jm.apply(p, xx, deterministic=False, rngs={"dropout": key})

    want = np.asarray(apply(params, jnp.asarray(x)))
    draws = list(recorded)
    assert draws, "the JAX block drew no mask"
    with recorded.replayed():
        (_, (jgrads, jgx)) = _jax_value_and_grads(apply, params, x, probe, jit=True)

    pm = _load(layers.Block(h * d, h, causal=True, **rates), params["params"]).train()
    xt = torch.from_numpy(x).requires_grad_()
    source = Replay(draws)
    with masks_from(source):
        got = pm(xt)
    assert not source.draws  # every JAX draw was taken, in order
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    (got * torch.from_numpy(np.array(probe))).sum().backward()
    _assert_grads(pm, jgrads, jgx, xt.grad)
    # eval mode, or no source: nothing is dropped
    jdet = jax.jit(jm.apply)(params, jnp.asarray(x))
    np.testing.assert_allclose(pm.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jdet), atol=ATOL)
    with masks_from(None):
        np.testing.assert_allclose(pm.train()(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jdet), atol=ATOL)


@pytest.mark.parametrize("d", [80, 88])
def test_block_attention_weights_and_qk_scale_match_jax(d):
    """``return_attention`` (the materialized route) with ``qk_scale`` and a
    key mask: the output and the weights."""
    b, n, h = 2, 7, 2
    x = _x(b, n, h * d, seed=3)
    mask = np.ones((b, n), bool)
    mask[0, 5:] = False
    jm = JBlock(dim=h * d, num_heads=h, qk_scale=0.05)
    params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))
    want, want_w = jax.jit(functools.partial(jm.apply, return_attention=True))(
        params, jnp.asarray(x), jnp.asarray(mask))
    pm = _load(layers.Block(h * d, h, qk_scale=0.05), params["params"]).eval()
    got, got_w = pm(torch.from_numpy(x), torch.from_numpy(mask), return_attention=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_w.detach().numpy(), np.asarray(want_w), atol=ATOL)
    # the kernel route agrees with the materialized one
    np.testing.assert_allclose(pm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy(),
                               np.asarray(want), atol=ATOL)


def test_patch_dropout_matches_jax_with_its_noise(recorded):
    x = _x(3, 11, 8)
    jm = JPatchDropout(keep_rate=0.6, num_prefix_tokens=1)
    want = jm.apply({}, jnp.asarray(x), deterministic=False, rngs={"dropout": jax.random.key(2)})
    pm = layers.PatchDropout(keep_rate=0.6, num_prefix_tokens=1).train()
    with masks_from(Replay(recorded)):
        got = pm(torch.from_numpy(x))
    assert got.shape == (3, 7, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pm.eval()(torch.from_numpy(x)).numpy(), x)


@pytest.mark.parametrize("learnable,init", [(True, 1 / 0.07), (False, 1 / 0.07), (True, 500.0)])
def test_logit_scaling_matches_jax(learnable, init):
    x = _x(4, 6)
    jm = JScaling(logit_scale_init=init, learnable=learnable)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    pm = layers.LearnableLogitScaling(init, learnable)
    if learnable:
        _load(pm, params["params"])
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))), rtol=1e-6)
    assert [n for n, _ in pm.named_parameters()] == (["log_logit_scale"] if learnable else [])


def test_embeddings_match_jax():
    """A patch embedding without a bias, ``ConvEmbed`` (SAME padding, odd and
    even sides) and the 1-D sin-cos table."""
    x = _x(2, 16, 16, 3)
    jm = JPatchEmbed(img_size=16, patch_size=8, embed_dim=80, use_bias=False)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    pm = _load(layers.PatchEmbed(8, 3, 80, use_bias=False), params["params"])
    assert "proj.bias" not in pm.state_dict()
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))), atol=ATOL)
    for side in (15,):  # odd: SAME pads one more after than before
        xc = _x(2, side, side, 3, seed=side)
        jc = JConvEmbed(channels=(8, 16), embed_dim=24, strides=(2, 2))
        cparams = jax.jit(jc.init)(jax.random.key(1), jnp.asarray(xc))
        pc = _load(layers.ConvEmbed((8, 16), 24, (2, 2)), cparams["params"])
        np.testing.assert_allclose(pc(torch.from_numpy(xc)).detach().numpy(),
                                   np.asarray(jax.jit(jc.apply)(cparams, jnp.asarray(xc))),
                                   atol=ATOL)
    np.testing.assert_array_equal(layers.get_1d_sincos_pos_embed(88, 7, cls_token=True),
                                  jax_sincos_1d(88, 7, cls_token=True))


VISION_CASES = {
    # CLIP-style: cls pooling, no patch-embedding bias, norm_pre, remat
    "d80_clip": dict(embed_dim=160, num_heads=2, use_cls_token=True, learned_pos_embed=True,
                     pre_norm=True, patch_embed_bias=False, global_pool="cls", proj_dim=16,
                     remat=True),
    # timm-style head: avg pooling, a biased projection, no final norm
    "d88_timm": dict(embed_dim=176, num_heads=2, global_pool="avg", proj_dim=16, proj_bias=True,
                     final_norm=False),
    "all_tokens": dict(embed_dim=176, num_heads=2, use_cls_token=True, proj_all_tokens=True,
                       proj_dim=16),
    # (the JAX draws are recorded concretely, so its tower runs without remat
    # here: the port's remat with masks is held by the tests below)
    "dropouts": dict(embed_dim=160, num_heads=2, use_cls_token=True, global_pool="cls",
                     proj_dim=16, drop_rate=0.2, attn_drop_rate=0.2, drop_path_rate=0.4,
                     patch_drop_rate=0.5),
}


@pytest.mark.parametrize("case", list(VISION_CASES))
def test_vision_options_match_jax(recorded, case):
    """The tower's outputs (each block's too) and, in train mode with the JAX
    draws replayed, its gradients."""
    cfg = dict(img_size=16, patch_size=4, depth=2, **VISION_CASES[case])
    x = _x(2, 16, 16, 3, seed=4)
    jm = JVision(**cfg)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    train = case == "dropouts"
    key = jax.random.key(3)
    kw = dict(deterministic=False, rngs={"dropout": key}) if train else {}
    apply = functools.partial(jm.apply, return_hidden_states=True, **kw)
    # the draws are recorded eagerly; without any, the forward compiles
    jout = (apply if train else jax.jit(apply))(params, jnp.asarray(x))
    draws = list(recorded)
    pm = _load(VisionTransformer(**cfg), params["params"])
    pm.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    with masks_from(Replay(draws) if train else None):
        out = pm(xt, return_hidden_states=True)
    np.testing.assert_allclose(out.last_hidden_state.detach().numpy(),
                               np.asarray(jout.last_hidden_state), atol=ATOL)
    assert (out.pooler_output is None) == (jout.pooler_output is None)
    if out.pooler_output is not None:
        np.testing.assert_allclose(out.pooler_output.detach().numpy(),
                                   np.asarray(jout.pooler_output), atol=ATOL)
    assert len(out.hidden_states) == len(jout.hidden_states) == 2
    for got, want in zip(out.hidden_states, jout.hidden_states):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    if train:
        probe = _x(*out.pooler_output.shape, seed=5)

        def apply(p, xx):
            return jm.apply(p, xx, **kw).pooler_output

        with recorded.replayed():
            _, (jgrads, jgx) = _jax_value_and_grads(apply, params, x, probe, jit=True)
        (out.pooler_output * torch.from_numpy(probe)).sum().backward()
        _assert_grads(pm, jgrads, jgx, xt.grad)


def test_predictor_drop_rates_match_jax(recorded):
    """The I-JEPA predictor's dropout, attention dropout and drop-path with
    the JAX draws replayed, heads of 80."""
    cfg = dict(num_patches=16, embed_dim=32, predictor_embed_dim=160, depth=2, num_heads=2,
               drop_rate=0.2, attn_drop_rate=0.2, drop_path_rate=0.5)
    z = _x(2, 5, 32, seed=12)
    enc = np.array([[[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]], np.int32)
    pred = np.array([[[10, 11, 12], [13, 14, 15]]], np.int32)
    jm = jvision.VisionTransformerPredictor(**cfg)
    args = (jnp.asarray(z), jnp.asarray(enc), jnp.asarray(pred))
    params = jax.jit(jm.init)(jax.random.key(0), *args)
    want = jm.apply(params, *args, deterministic=False, rngs={"dropout": jax.random.key(5)})
    pm = _load(pvision.VisionTransformerPredictor(**cfg), params["params"]).train()
    with masks_from(Replay(recorded)):
        got = pm(torch.from_numpy(z), torch.from_numpy(enc), torch.from_numpy(pred))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


TEXT_CASES = {
    "bert": dict(causal=False, use_token_type=True, pooling="cls", proj_dim=16),
    "none_pooling": dict(pooling="none", proj_dim=16),
    "all_tokens_elided": dict(proj_all_tokens=True, proj_dim=16, elide_padding_mask=True),
    "dropouts": dict(drop_rate=0.2, attn_drop_rate=0.3, proj_dim=16, remat=True, depth=1),
}


@pytest.mark.parametrize("case", list(TEXT_CASES))
def test_text_options_match_jax(recorded, case):
    cfg = {**dict(vocab_size=40, max_length=9, embed_dim=160, depth=2, num_heads=2),
           **TEXT_CASES[case]}
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 38, (3, 9)).astype(np.int32)
    ids[:, 6] = 39
    mask = np.ones((3, 9), np.int32)
    mask[:, 7:] = 0
    jm = JText(**cfg)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    train = case == "dropouts"
    kw = dict(deterministic=False, rngs={"dropout": jax.random.key(4)}) if train else {}
    apply = functools.partial(jm.apply, return_hidden_states=True, **kw)
    jout = (apply if train else jax.jit(apply))(params, jnp.asarray(ids), jnp.asarray(mask))
    pm = _load(TextTransformer(**cfg), params["params"])
    pm.train(train)
    with masks_from(Replay(recorded) if train else None):
        out = pm(torch.from_numpy(ids), torch.from_numpy(mask), return_hidden_states=True)
    np.testing.assert_allclose(out.last_hidden_state.detach().numpy(),
                               np.asarray(jout.last_hidden_state), atol=ATOL)
    assert (out.pooler_output is None) == (jout.pooler_output is None)
    if out.pooler_output is not None:
        np.testing.assert_allclose(out.pooler_output.detach().numpy(),
                                   np.asarray(jout.pooler_output), atol=ATOL)
    for got, want in zip(out.hidden_states, jout.hidden_states, strict=True):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def _tower(remat, drop_path=0.0):
    return dict(img_size=16, patch_size=8, embed_dim=160, depth=2, num_heads=2,
                use_cls_token=True, global_pool="cls", proj_dim=8, remat=remat,
                drop_path_rate=drop_path)


def test_remat_step_equals_the_step_without_remat():
    """The same step with every block checkpointed (``dots_no_batch``, and
    saving nothing) and without: loss and gradients equal bit for bit, with
    drop-path on and the same masks. The products the step computes show
    what each policy recomputes: nothing without remat, the attention's
    batched products under ``dots_no_batch`` (the projections' 2-D
    products saved), those and the projections' again saving nothing."""
    x = torch.from_numpy(_x(4, 16, 16, 3, seed=8))
    runs = []
    for remat, policy in ((False, None), (True, "dots_no_batch"), (True, None)):
        tower = VisionTransformer(**_tower(remat, drop_path=0.5), remat_policy=policy,
                                  generator=torch.Generator().manual_seed(0)).train()

        def step(tower=tower):
            with masks_from(MaskSource(9, "cpu")):
                loss = tower(x).pooler_output.square().sum()
            loss.backward()
            return loss

        loss, flops = count_flops(step)
        runs.append((loss.detach(), [p.grad.clone() for p in tower.parameters()], flops))
    for loss, grads, _ in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(g, w) for g, w in zip(grads, runs[0][1]))
    plain, saved, nothing = (flops for _, _, flops in runs)
    n, d, blocks = 5, 80, 2  # 4 patches + cls, heads of 80
    attention_fwd = blocks * 4 * 4 * 2 * n * n * d  # scores and p v, each 2 B H N^2 D
    assert saved == plain + attention_fwd
    assert nothing > saved


def test_dots_no_batch_saves_no_integer_sum():
    """``dots_no_batch`` saves the 2-D products but not the f64 ones (the
    exact integer sums of ``MMLEARN_QUANT``'s int8 modes), nor batched ones."""
    from torch.utils.checkpoint import CheckpointPolicy

    from mmlearn_tpu_torch.modules.layers.transformer_block import _dots_no_batch

    a32, a64 = torch.ones(2, 2), torch.ones(2, 2, dtype=torch.float64)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert _dots_no_batch(None, mm, a32, a32) == CheckpointPolicy.MUST_SAVE
    assert _dots_no_batch(None, torch.ops.aten.addmm.default, a32, a32, a32) == (
        CheckpointPolicy.MUST_SAVE)
    assert _dots_no_batch(None, mm, a64, a64) == CheckpointPolicy.PREFER_RECOMPUTE
    assert _dots_no_batch(None, bmm, a32[None], a32[None]) == CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "scanned"])
def test_remat_encoder_gradients_match_jax(scan):
    """The JAX tower under ``nn.remat`` (its scanned stack with the
    ``dots_no_batch`` policy) against the port's, both checkpointed; the
    scanned tree crosses the bridge both ways."""
    cfg = _tower(True)
    x = _x(2, 16, 16, 3, seed=10)
    jm = JVision(**cfg, scan_blocks=scan)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    probe = _x(2, 8, seed=11)
    _, (jgrads, jgx) = _jax_value_and_grads(lambda p, xx: jm.apply(p, xx).pooler_output,
                                            params, x, probe, jit=True)
    pm = _load(VisionTransformer(**cfg), params["params"]).train()
    xt = torch.from_numpy(x).requires_grad_()
    (pm(xt).pooler_output * torch.from_numpy(probe)).sum().backward()
    _assert_grads(pm, jgrads, jgx, xt.grad)
    flat = bridge.flatten(jax.device_get(params["params"]))
    back = bridge.torch_to_jax(pm, scanned=scan)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def _port_path(name: str, shape) -> tuple[str, tuple]:
    """A port parameter's JAX path and shape, by the bridge's rules, for
    shapes alone (nothing allocated)."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        if len(shape) == 2 and mods[-1] not in ("token_embedding", "token_type_embedding"):
            leaf, shape = "kernel", tuple(reversed(shape))
        elif len(shape) == 4:
            leaf, shape = "kernel", (shape[1], shape[2], shape[3], shape[0])
        else:
            leaf = "embedding" if len(shape) == 2 else "scale"
    return "/".join([*mods, leaf]).replace("blocks/", "blocks_"), tuple(shape)


@pytest.mark.parametrize("size", list(jvision._VIT_DIMS))
def test_presets_match_jax_shapes_and_counts(size):
    """Each ``vit_*`` preset at 14-px patches: every parameter's path and
    shape equal to the JAX preset's, counted without allocating (``jax.
    eval_shape`` on one side, the ``meta`` device on the other)."""
    assert pvision._VIT_DIMS[size] == jvision._VIT_DIMS[size]
    kw = dict(img_size=224, patch_size=14, use_cls_token=True, learned_pos_embed=True,
              global_pool="cls", proj_dim=1024, patch_embed_bias=False)
    jm = getattr(jvision, f"vit_{size}")(**kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    want = {"/".join(k.key for k in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    with torch.device("meta"):
        pm = getattr(pvision, f"vit_{size}")(**kw)
    got = dict(_port_path(n, p.shape) for n, p in pm.named_parameters())
    assert got == want
    total = sum(int(np.prod(s)) for s in want.values())
    assert sum(p.numel() for p in pm.parameters()) == total
    heads = jvision._VIT_DIMS[size]["num_heads"]
    assert pm.blocks[0].attn.num_heads == heads


def test_bridge_round_trips_every_new_parameter():
    """A patch embedding without bias, a biased projection, the token-type
    table and a ``LearnableLogitScaling``: JAX -> port -> JAX unchanged."""
    vcfg = dict(img_size=16, patch_size=8, embed_dim=160, depth=1, num_heads=2,
                use_cls_token=True, global_pool="cls", proj_dim=8, proj_bias=True,
                patch_embed_bias=False)
    tcfg = dict(vocab_size=20, max_length=6, embed_dim=176, depth=1, num_heads=2,
                use_token_type=True, proj_dim=8)
    for jm, pm, arg in ((JVision(**vcfg), VisionTransformer(**vcfg), jnp.zeros((1, 16, 16, 3))),
                        (JText(**tcfg), TextTransformer(**tcfg), jnp.ones((1, 6), jnp.int32)),
                        (JScaling(), layers.LearnableLogitScaling(), jnp.ones((2,)))):
        params = jax.device_get(jax.jit(jm.init)(jax.random.key(3), arg)["params"])
        flat = bridge.flatten(params)
        pm.load_state_dict(bridge.jax_to_torch(params), strict=True)
        back = bridge.torch_to_jax(pm)
        assert sorted(back) == sorted(flat)
        for path, arr in flat.items():
            np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_flops_of_a_remat_step_match_the_jax_walker():
    """The FLOP counter over a step of a pair whose towers are checkpointed
    (``dots_no_batch``): the recompute counted where the code runs it, the
    JAX walker's count of the same remat step (its scanned stacks) plus the
    one term the port's step without remat already differs by (its
    attention backward recomputes the scores); with remat the port counts
    more than without (the attention's forward run again)."""
    vcfg = dict(img_size=16, patch_size=8, embed_dim=160, depth=1, num_heads=2,
                use_cls_token=True, global_pool="cls", proj_dim=16)
    tcfg = dict(vocab_size=32, max_length=8, embed_dim=160, depth=1, num_heads=2, causal=True,
                pooling="eos", proj_dim=16)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 30, (4, 8)).astype(np.int32)
    ids[:, -1] = 31
    batch = {"rgb": rng.standard_normal((4, 16, 16, 3)).astype(np.float32), "text": ids}
    extra = dict(remat=True, scan_blocks=True)
    jtask = JTask(encoders={"rgb": JVision(**vcfg, **extra), "text": JText(**tcfg, **extra)},
                  optimizer=functools.partial(optax.adamw, learning_rate=1e-3))
    params = jtask.init_params(jax.random.key(0), batch)

    def loss(p):
        return jtask.loss_fn(p, batch, jax.random.key(1), {}, deterministic=False)[0]

    port = {}
    for remat in (False, True):
        task = ContrastivePretraining({"rgb": VisionTransformer(**vcfg, remat=remat),
                                       "text": TextTransformer(**tcfg, remat=remat)})
        task.load_state_dict(bridge.jax_to_torch(jax.device_get(params)))
        _, port[remat] = count_flops(lambda: task.loss_fn(batch)[0].backward())
    n_img = (16 // 8) ** 2 + 1
    scores = sum(2 * 4 * 2 * n * n * 80 for n in (n_img, 8))  # a block a tower
    assert port[True] == step_flops(jax.value_and_grad(loss), params) + scores
    assert port[True] > port[False]  # the attention's forward, run again


def test_trainer_draws_each_micro_steps_masks_from_its_seed():
    """``Trainer.fit`` gives micro-step i the masks of ``(seed, i)``: two fits
    with drop-path and dropout give the same history bit for bit, another
    seed another one; outside ``fit`` nothing is dropped."""
    def fit(seed):
        g = torch.Generator().manual_seed(0)
        task = ContrastivePretraining(
            {"rgb": VisionTransformer(**_tower(True, drop_path=0.5), drop_rate=0.2, generator=g),
             "text": TextTransformer(vocab_size=32, max_length=8, embed_dim=64, depth=1,
                                     num_heads=2, proj_dim=8, drop_rate=0.2, generator=g)},
            optimizer=functools.partial(torch.optim.AdamW, lr=1e-3))
        rng = np.random.default_rng(1)
        ids = rng.integers(1, 30, (4, 8)).astype(np.int32)
        ids[:, -1] = 31
        batches = [{"rgb": rng.standard_normal((4, 16, 16, 3)).astype(np.float32), "text": ids}
                   for _ in range(3)]
        trainer = Trainer(max_steps=3, log_every_n_steps=1, device="cpu", seed=seed)
        trainer.fit(task, batches)
        return [h["loss"] for h in trainer.history], task, batches[0]

    losses, task, batch = fit(0)
    assert fit(0)[0] == losses
    assert fit(1)[0] != losses
    task.train()
    assert torch.equal(task.loss_fn(batch)[0], task.loss_fn(batch)[0])
    a, b = step_source(0, 3, "cpu"), step_source(0, 3, "cpu")
    assert torch.equal(a.keep(0.5, (64,)), b.keep(0.5, (64,)))
    assert not torch.equal(step_source(0, 4, "cpu").keep(0.5, (64,)),
                           step_source(0, 3, "cpu").keep(0.5, (64,)))
