"""The ``MMLEARN_QUANT`` modes of the PyTorch port against the JAX package on
the CPU: the mode read at every call, the int8 products and their gradients
(``int8_fwd``, ``int8``, ``int8_sb``), the projection factory, the bridge
over a quantized tower, ``Int8Dense``'s bias under ``int8_sb`` (added in
K5's epilogue), and the tiny CLIP pair's step, ten-step trajectory and
thirty-step trajectory against the JAX package under ``int8_sb``.

Inputs are made from a seed with numpy and fed to both packages in f32.
Each test states its tolerance.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.layers.mlp import MLP as JMLP
from mmlearn_tpu.modules.layers.quantization import Int8Dense as JInt8Dense
from mmlearn_tpu.modules.layers.quantization import int8_matmul_full as jax_full
from mmlearn_tpu.modules.layers.quantization import int8_matmul_ste as jax_ste
from mmlearn_tpu.ops.int8_matmul import switchback_matmul as jax_sb
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import VisionTransformer
from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformerPredictor
from mmlearn_tpu_torch.modules.layers import MLP, Dense, Int8Dense, quant_mode
from mmlearn_tpu_torch.modules.layers.quantization import int8_matmul_full, int8_matmul_ste
from mmlearn_tpu_torch.ops.int8_matmul import switchback_matmul
from mmlearn_tpu_torch.trainer import Trainer
from tests.test_torch_encoders import TINY_VISION
from tests.test_torch_training import STEPS, _training_pair

QUANT = "MMLEARN_QUANT"
PRODUCTS = {"int8_fwd": (int8_matmul_ste, jax_ste), "int8": (int8_matmul_full, jax_full),
            "int8_sb": (switchback_matmul, jax_sb)}


def _data(m=64, k=96, n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    c = rng.standard_normal((4, m, n)).astype(np.float32)
    return x, w, c


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_quant_mode_is_read_at_every_call(monkeypatch):
    """One MLP with the same weights, the variable flipped between calls, in
    both packages: each mode agrees with the JAX package (atol 1e-5, f32),
    the quantized outputs stay within 5% of the plain one (the JAX test's
    bound) and an unknown mode computes exactly as Dense."""
    monkeypatch.delenv(QUANT, raising=False)
    assert quant_mode() is None
    x, _, _ = _data(m=8)
    jmlp = JMLP(hidden_dims=[64], out_dim=96)
    params = jmlp.init(jax.random.key(0), jnp.asarray(x))
    mlp = MLP(96, out_dim=96, hidden_dims=[64])
    mlp.load_state_dict(bridge.jax_to_torch(jax.device_get(params["params"])), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        base = mlp(xt).numpy()
        for mode in (None, "int8_fwd", "int8", "int8_sb", "fp4"):
            if mode is None:
                monkeypatch.delenv(QUANT, raising=False)
            else:
                monkeypatch.setenv(QUANT, mode.upper())  # the JAX package lowers it too
            assert quant_mode() == (None if mode is None else mode)
            got = mlp(xt).numpy()
            np.testing.assert_allclose(got, np.asarray(jmlp.apply(params, jnp.asarray(x))),
                                       atol=1e-5)
            err = np.linalg.norm(got - base) / np.linalg.norm(base)
            if mode in PRODUCTS:
                assert 0.0 < err < 0.05, (mode, err)
            else:
                np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("mode", list(PRODUCTS))
def test_products_and_gradients_match_jax(mode, monkeypatch):
    """Each mode's ``x @ w`` and both gradients under a fixed cotangent
    against ``jax.grad`` of the JAX product (``int8_sb`` with its kernel in
    interpret mode), f32: rtol 1e-5, atol 1e-6 (the JAX package's own)."""
    monkeypatch.setenv("MMLEARN_INT8_QMM_INTERPRET", "1")
    x, w, c = _data(m=10, k=96, n=160, seed=1)
    port_fn, jax_fn = PRODUCTS[mode]

    def loss(x, w):
        return jnp.sum(jax_fn(x, w) * c)

    want_gx, want_gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    y = port_fn(xt, wt)
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax_fn(x, w)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(want_gw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", list(PRODUCTS))
def test_integer_operands_are_exact(mode):
    """Integer operands whose every row and column reach 127 quantize with
    scale 1 in every direction: the product and both gradients equal f32
    math bit for bit (tests/modules/test_quantization.py:183-214)."""
    rng = np.random.default_rng(3)

    def mk(shape):
        a = rng.integers(-127, 128, shape).astype(np.float32)
        a[:, 0] = 127.0
        a[0, :] = 127.0
        return torch.from_numpy(a)

    x, w, c = mk((16, 24)), mk((160, 24)), mk((16, 160))
    xq, wq = x.clone().requires_grad_(), w.clone().requires_grad_()
    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    yq = PRODUCTS[mode][0](xq, wq)
    yf = xf @ wf.t()
    torch.testing.assert_close(yq, yf, rtol=0, atol=0)
    (yq * c).sum().backward()
    (yf * c).sum().backward()
    torch.testing.assert_close(xq.grad, xf.grad, rtol=0, atol=0)
    torch.testing.assert_close(wq.grad, wf.grad, rtol=0, atol=0)


def test_block_projections_follow_the_mode():
    """The block projections (attention qkv/proj, MLP fc1/fc2) follow the
    mode; the towers' heads and the I-JEPA predictor's in/out projections
    stay plain Dense, as they are ``nn.Dense`` in the JAX package."""
    vit = VisionTransformer(**TINY_VISION)
    for block in vit.blocks:
        for layer in (block.attn.qkv, block.attn.proj, block.mlp.fc1, block.mlp.fc2):
            assert isinstance(layer, Int8Dense)
    assert type(vit.proj) is Dense
    pred = VisionTransformerPredictor(embed_dim=32, predictor_embed_dim=16, depth=1,
                                      num_heads=2, num_patches=4)
    assert type(pred.predictor_embed) is Dense and type(pred.predictor_proj) is Dense
    assert isinstance(pred.blocks[0].mlp.fc1, Int8Dense)
    # the same parameters as Dense: names, shapes, types
    q, d = Int8Dense(8, 16), Dense(8, 16)
    assert {k: (v.shape, v.dtype) for k, v in q.state_dict().items()} == {
        k: (v.shape, v.dtype) for k, v in d.state_dict().items()}


def test_bridge_carries_a_quantized_tower(monkeypatch):
    """A JAX tower initialised under ``int8_sb`` (its projections are
    ``Int8Dense``) loads into the port with ``strict=True`` and comes back
    as the same leaves bit for bit; both towers then embed alike under the
    mode (atol 1e-5: both quantize the same f32 values)."""
    monkeypatch.setenv(QUANT, "int8_sb")
    rng = np.random.default_rng(4)
    images = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    jvit = JVision(**TINY_VISION)
    params = jax.jit(jvit.init)(jax.random.key(0), jnp.asarray(images))["params"]
    vit = VisionTransformer(**TINY_VISION)
    vit.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)
    want = bridge.flatten(jax.device_get(params))
    back = bridge.torch_to_jax(vit)
    assert back.keys() == want.keys()
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    with torch.no_grad():
        got = vit(torch.from_numpy(images)).pooler_output.numpy()
    ref = np.asarray(jvit.apply({"params": params}, jnp.asarray(images)).pooler_output)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _grads_as_jax(task) -> dict:
    """The port task's gradients as flat JAX paths."""
    twin = copy.deepcopy(task)
    with torch.no_grad():
        for p, q in zip(task.parameters(), twin.parameters()):
            q.copy_(p.grad)
    return bridge.torch_to_jax(twin)


def test_tiny_pair_step_under_int8_sb_matches_jax(monkeypatch):
    """One step of the tiny CLIP pair under ``int8_sb`` from the same
    (bridged) weights: the loss to 1e-4 relative and every gradient tensor
    to cosine 0.999 against ``jax.value_and_grad`` of the JAX task (the
    JAX package runs its composed int8 product here, the same numbers as
    its kernel). Reads: loss rel diff 0 to 1e-7, least cosine 0.99999."""
    monkeypatch.setenv(QUANT, "int8_sb")
    jtask, params, batches, ptask = _training_pair()
    batch = batches[0]
    rng = jax.random.key(1)

    def loss_wrap(p):
        return jtask.loss_fn(p, batch, rng, {}, deterministic=False)[0]

    want, grads = jax.jit(jax.value_and_grad(loss_wrap))(params)
    loss, _ = ptask.loss_fn(batch)
    loss.backward()
    rel = abs(loss.item() - float(want)) / abs(float(want))
    assert rel <= 1e-4, rel
    got = _grads_as_jax(ptask)
    flat = bridge.flatten(jax.device_get(grads))
    assert got.keys() == flat.keys()
    cos = {path: _cosine(got[path].ravel(), g.ravel()) for path, g in flat.items()}
    print(f"loss rel diff {rel:.3e}, least cosine {min(cos.values()):.7f}")
    assert min(cos.values()) >= 0.999, cos


def test_int8_sb_trajectory_tracks_the_unquantized_one(monkeypatch):
    """Ten ``Trainer.fit`` steps of the tiny pair under ``int8_sb`` against
    the same steps unquantized, from the same weights: the JAX package's
    gate (tests/modules/test_quantization.py:333-392), every loss within
    15% and the last within 10%, and the quantized run trains."""
    _, _, batches, ptask = _training_pair()
    losses = {}
    for mode in (None, "int8_sb"):
        if mode is None:
            monkeypatch.delenv(QUANT, raising=False)
        else:
            monkeypatch.setenv(QUANT, mode)
        trainer = Trainer(max_steps=STEPS, log_every_n_steps=1, device="cpu")
        trainer.fit(copy.deepcopy(ptask), batches)
        losses[mode] = np.array([h["loss"] for h in trainer.history])
    base, quant = losses[None], losses["int8_sb"]
    assert quant[-1] < quant[0], quant
    assert float(np.max(np.abs(quant - base) / np.abs(base))) < 0.15, (base, quant)
    assert abs(quant[-1] - base[-1]) / base[-1] < 0.10, (base[-1], quant[-1])


def test_int8_dense_bias_under_int8_sb_matches_jax(monkeypatch):
    """``Int8Dense`` under ``int8_sb`` with a nonzero bias, which the port
    adds in K5's epilogue (its plain version on the CPU) and the JAX package
    after the product: the output and the gradients of x, the weight and the
    bias against ``jax.grad`` of the JAX layer with its kernel in interpret
    mode, f32, rtol 1e-5 and atol 1e-6 (the JAX package's own), at a shape
    K5 takes and at one it refuses (N < 128: the composed product and a
    separate add)."""
    monkeypatch.setenv(QUANT, "int8_sb")
    monkeypatch.setenv("MMLEARN_INT8_QMM_INTERPRET", "1")
    for n in (160, 96):
        x, w, c = _data(m=10, k=96, n=n, seed=n)
        bias = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
        jlayer = JInt8Dense(features=n, mode="int8_sb")
        params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}

        def loss(x, p, layer=jlayer, c=c):
            return jnp.sum(layer.apply(p, x) * c)

        want_y = np.asarray(jlayer.apply(params, jnp.asarray(x)))
        want_gx, want_gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
        layer = Int8Dense(96, n)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            layer.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).requires_grad_()
        y = layer(xt)
        (y * torch.from_numpy(c)).sum().backward()
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(y.detach().numpy(), want_y, **tol)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **tol)
        np.testing.assert_allclose(layer.weight.grad.numpy().T,
                                   np.asarray(want_gp["params"]["kernel"]), **tol)
        np.testing.assert_allclose(layer.bias.grad.numpy(),
                                   np.asarray(want_gp["params"]["bias"]), **tol)


TRAJECTORY_STEPS = 30


def test_tiny_pair_int8_sb_trajectory_matches_jax(monkeypatch):
    """Thirty ``Trainer.fit`` steps of the tiny CLIP pair under ``int8_sb``
    against the JAX package's ``value_and_grad`` + ``tx.update`` loop under
    the same mode, from the same (bridged) weights: the loss and the
    gradient norm step by step.

    Both quantize f32 values that differ by f32 sums in other orders; where
    one falls on the other side of an int8 rounding edge, that element moves
    by a quantization step, and the two trajectories part from then on (the
    unquantized ones stay within 6e-5 over the same thirty steps). Readings
    (the same at 1, 3 and the default number of threads): the first two steps, before a flip can
    have moved the weights, 2.0e-7 on the loss and 1.6e-7 on the gradient
    norm; over all thirty, 9.44e-2 (step 13, loss 0.0089) and 1.67e-1 (step
    22). Limits about 2x those: 1e-6 on the first two steps, 0.2 and 0.35
    over the run; and both runs train."""
    monkeypatch.setenv(QUANT, "int8_sb")
    jtask, params, batches, ptask = _training_pair()
    tx = jtask.configure_optimizers(max_steps=TRAJECTORY_STEPS)
    opt_state = tx.init(params)
    rng = jax.random.key(1)

    @jax.jit
    def train_step(params, opt_state, batch):
        def loss_wrap(p):
            return jtask.loss_fn(p, batch, rng, {}, deterministic=False)[0]

        loss, grads = jax.value_and_grad(loss_wrap)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    want = {"loss": [], "grad_norm": []}
    for i in range(TRAJECTORY_STEPS):
        params, opt_state, loss, gnorm = train_step(params, opt_state, batches[i % 2])
        want["loss"].append(float(loss))
        want["grad_norm"].append(float(gnorm))

    trainer = Trainer(max_steps=TRAJECTORY_STEPS, log_every_n_steps=1, device="cpu")
    trainer.fit(ptask, batches)
    got = {k: np.array([h[k] for h in trainer.history]) for k in want}
    rel = {k: np.abs(got[k] - want[k]) / np.abs(want[k]) for k in want}
    print({k: f"{v[:2].max():.3e}, {v.max():.3e} at step {int(v.argmax())}"
           for k, v in rel.items()})
    for k, limit in (("loss", 0.2), ("grad_norm", 0.35)):
        np.testing.assert_allclose(got[k][:2], want[k][:2], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=limit, err_msg=k)
    assert got["loss"][-1] < 0.01 * got["loss"][0] and want["loss"][-1] < 0.01 * want["loss"][0]
