"""The I-JEPA slice of the PyTorch port against the JAX package on the CPU:
the mask generator, ``apply_masks`` and ``repeat_interleave_batch``, the
encoder with patch masks, the predictor, the EMA teacher, the data2vec
losses, the task's loss and gradients, and ``Trainer.fit`` over the 30 steps
of the recorded reference trajectory.

Weights cross through ``mmlearn_tpu_torch.bridge``; inputs are made from a
seed with numpy and fed to both packages in f32. Each test states its
tolerance.
"""

import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.datasets.processors.masking import IJEPAMaskGenerator as JMasks
from mmlearn_tpu.modules.ema import ExponentialMovingAverage as JEMA
from mmlearn_tpu.modules.encoders.vision import VisionTransformer as JVision
from mmlearn_tpu.modules.encoders.vision import VisionTransformerPredictor as JPredictor
from mmlearn_tpu.modules.encoders.vision import apply_masks as j_apply_masks
from mmlearn_tpu.modules.encoders.vision import repeat_interleave_batch as j_repeat
from mmlearn_tpu.modules.losses.data2vec import Data2VecLoss as JData2Vec
from mmlearn_tpu.modules.losses.data2vec import smooth_l1 as j_smooth_l1
from mmlearn_tpu.tasks import IJEPA as JIJEPA
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.datasets.processors import IJEPAMaskGenerator
from mmlearn_tpu_torch.flagship import ijepa_batch, ijepa_training_task
from mmlearn_tpu_torch.modules.ema import ExponentialMovingAverage
from mmlearn_tpu_torch.modules.encoders import (
    VisionTransformer,
    VisionTransformerPredictor,
    apply_masks,
    repeat_interleave_batch,
)
from mmlearn_tpu_torch.modules.losses import Data2VecLoss, smooth_l1
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.tasks import IJEPA
from mmlearn_tpu_torch.tasks.ijepa import ENCODER_MASK_KEY, PREDICTOR_MASK_KEY, standardize
from mmlearn_tpu_torch.trainer import Trainer
from tests.tasks.test_training_trajectory import (
    IJEPA_FIXTURE,
    IJEPA_TRAJ,
    _binary_masks_to_indices,
    make_ijepa_data,
)

ATOL = 1e-5  # f32 end to end; sums in another order

# the whole-step geometry: 4 x 4 patches, width 32, 4 heads, predictor width
# 16 at the JAX task's default depth (encoder depth // 2)
TINY_ENCODER = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4)
TINY_PREDICTOR = dict(num_patches=16, embed_dim=32, predictor_embed_dim=16, depth=1,
                      num_heads=4)


def _noisy(tree, scale, seed):
    """``tree`` plus seeded numpy noise (one draw a leaf)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(tree))


def _images(b, seed=0, size=64):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _masks(b, seed=0, n_enc=1, size=64):
    return JMasks(input_size=size, patch_size=16, nenc=n_enc)(
        b, rng=np.random.default_rng(seed))


# -------------------------------------------------------------------- masks


@pytest.mark.parametrize("kw", [
    dict(), dict(input_size=64), dict(nenc=2, npred=3),
    dict(allow_overlap=True, aspect_ratio=(0.5, 2.0)),
], ids=["vit_b16", "tiny", "two_contexts", "overlap"])
def test_mask_generator_matches_jax_draw_for_draw(kw):
    """The same numpy generator gives the same int32 arrays."""
    want = JMasks(**kw)(16, rng=np.random.default_rng(3))
    got = IJEPAMaskGenerator(**kw)(16, rng=np.random.default_rng(3))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_mask_generator_keep_counts_at_224():
    gen = IJEPAMaskGenerator()
    assert (gen.k_tgt, gen.k_ctx) == (34, 84)  # the predictor's N = 118
    out = gen(4, rng=np.random.default_rng(0))
    assert out["encoder_masks"].shape == (1, 4, 84)
    assert out["predictor_masks"].shape == (4, 4, 34)
    for b in range(4):  # the context leaves out every target patch
        assert not set(out["encoder_masks"][0, b]) & set(out["predictor_masks"][:, b].ravel())


# ------------------------------------------------------ gathers and repeats


def test_apply_masks_and_repeat_interleave_batch_match_jax():
    """Pure gathers and copies: exact."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 5)).astype(np.float32)
    masks = rng.integers(0, 16, (2, 3, 7)).astype(np.int32)
    got = apply_masks(torch.from_numpy(x), torch.from_numpy(masks))
    want = j_apply_masks(jnp.asarray(x), jnp.asarray(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(  # a (B, K) mask is one mask
        apply_masks(torch.from_numpy(x), torch.from_numpy(masks[0])).numpy(),
        np.asarray(j_apply_masks(jnp.asarray(x), jnp.asarray(masks[0]))))
    y = rng.standard_normal((6, 4, 5)).astype(np.float32)
    for b, repeat in ((3, 2), (2, 3), (6, 1)):
        np.testing.assert_array_equal(
            repeat_interleave_batch(torch.from_numpy(y), b, repeat).numpy(),
            np.asarray(j_repeat(jnp.asarray(y), b, repeat)))
    # a tile of each group, not torch.repeat_interleave
    z = torch.arange(4.0)[:, None]
    assert repeat_interleave_batch(z, 2, 2).flatten().tolist() == [0, 1, 0, 1, 2, 3, 2, 3]


# ------------------------------------------------------ encoder, predictor


@pytest.mark.parametrize("cls_token", [False, True], ids=["ijepa", "cls"])
def test_encoder_with_patch_masks_matches_jax(cls_token):
    kw = dict(TINY_ENCODER, use_cls_token=cls_token)
    jenc = JVision(**kw)
    images = _images(3)
    masks = _masks(3, n_enc=2)["encoder_masks"]
    params = jax.jit(jenc.init)(jax.random.key(0), jnp.asarray(images))["params"]
    want = jax.jit(lambda p, x, m: jenc.apply({"params": p}, x, patch_masks=m))(
        params, jnp.asarray(images), jnp.asarray(masks)).last_hidden_state
    enc = VisionTransformer(**kw)
    enc.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(images), patch_masks=torch.from_numpy(masks))
    assert got.last_hidden_state.shape == (2 * 3, masks.shape[-1] + cls_token, 32)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n_enc", [1, 2])
def test_predictor_matches_jax(n_enc):
    jpred = JPredictor(**TINY_PREDICTOR)
    masks = _masks(3, seed=2, n_enc=n_enc)
    enc_m, pred_m = masks["encoder_masks"], masks["predictor_masks"]
    z = np.random.default_rng(4).standard_normal(
        (n_enc * 3, enc_m.shape[-1], 32)).astype(np.float32)
    args = (jnp.asarray(z), jnp.asarray(enc_m), jnp.asarray(pred_m))
    params = jax.jit(jpred.init)(jax.random.key(1), *args)["params"]
    params = _noisy(params, 0.1, seed=2)  # a mask token and biases far from 0
    want = jax.jit(lambda p, *a: jpred.apply({"params": p}, *a))(params, *args)
    pred = VisionTransformerPredictor(**TINY_PREDICTOR)
    pred.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = pred(torch.from_numpy(z), torch.from_numpy(enc_m), torch.from_numpy(pred_m))
    assert got.shape == (4 * n_enc * 3, pred_m.shape[-1], 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------- EMA, loss


def test_ema_rate_matches_jax():
    for kw in (dict(ema_decay=0.996, ema_end_decay=1.0, ema_anneal_end_step=100_000),
               dict(ema_decay=0.9, ema_end_decay=0.99, ema_anneal_end_step=7),
               dict(ema_decay=0.5, ema_end_decay=0.5, ema_anneal_end_step=10)):
        jema, ema = JEMA(**kw), ExponentialMovingAverage(**kw)
        for n in (0, 1, 3, 7, 50, 99_999, 100_000, 250_000):
            assert ema.get_annealed_rate(n) == float(jema.get_annealed_rate(n)), (kw, n)


@pytest.mark.parametrize("skip_keys", [(), ("norm",)], ids=["all", "skip_norms"])
def test_ema_step_matches_jax(skip_keys):
    """One update of a tiny encoder's weights; f32, one product and one sum
    in another order: rtol 1e-6."""
    init = jax.jit(JVision(**TINY_ENCODER).init)
    ema_tree = init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    new_tree = _noisy(init(jax.random.key(1), jnp.zeros((1, 64, 64, 3)))["params"], 0.5, 1)
    jema = JEMA(ema_decay=0.9, ema_end_decay=0.99, ema_anneal_end_step=10,
                skip_keys=skip_keys)
    want = bridge.jax_to_torch(jax.device_get(jax.jit(jema.step)(ema_tree, new_tree, 4)))
    teacher, student = VisionTransformer(**TINY_ENCODER), VisionTransformer(**TINY_ENCODER)
    teacher.load_state_dict(bridge.jax_to_torch(jax.device_get(ema_tree)))
    student.load_state_dict(bridge.jax_to_torch(jax.device_get(new_tree)))
    ExponentialMovingAverage(ema_decay=0.9, ema_end_decay=0.99, ema_anneal_end_step=10,
                             skip_keys=skip_keys).step(teacher, student, 4)
    got = teacher.state_dict()
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.parametrize("beta", [0.0, 0.5])
@pytest.mark.parametrize("loss_scale", [None, 2.0])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_data2vec_loss_matches_jax(beta, loss_scale, reduction):
    """f32, sums in another order: rtol 1e-6."""
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((3, 5, 8)).astype(np.float32) for _ in range(2))
    want = JData2Vec(beta=beta, loss_scale=loss_scale, reduction=reduction)(
        jnp.asarray(x), jnp.asarray(y))
    got = Data2VecLoss(beta=beta, loss_scale=loss_scale, reduction=reduction)(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if beta:
        np.testing.assert_allclose(
            smooth_l1(torch.from_numpy(x), torch.from_numpy(y), beta).numpy(),
            np.asarray(j_smooth_l1(jnp.asarray(x), jnp.asarray(y), beta)), rtol=1e-6)
    with pytest.raises(ValueError, match="Shape mismatch"):
        Data2VecLoss()(torch.zeros(2, 3), torch.zeros(3, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_standardize_matches_jax(dtype):
    """``jax.nn.standardize``'s own formula and roundings: f32 to 2e-6; bf16
    to one bf16 rounding of values up to ~4 (1.6e-2)."""
    rng = np.random.default_rng(7)
    x = (3 + 2 * rng.standard_normal((4, 6, 64))).astype(np.float32)
    x[0, 0] = 5.0  # a constant row: variance 0 (clipped), not NaN
    want = np.asarray(jax.nn.standardize(jnp.asarray(x, dtype), axis=-1, epsilon=1e-5),
                      np.float32)
    got = standardize(torch.from_numpy(x).to(getattr(torch, dtype)), 1e-5).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-6 if dtype == "float32" else 1.6e-2)


# ------------------------------------------------- recorded reference gates

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def test_data2vec_loss_and_ema_rates_match_the_recorded_reference():
    """The recorded reference values of ``reference_d2v_ema.npz``, at the
    JAX package's tolerances (tests/modules/test_reference_parity.py:72-109)."""
    ref = np.load(os.path.join(FIXTURES, "reference_d2v_ema.npz"))
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"])
    for name, kw in {"mse": dict(beta=0.0, reduction="mean"),
                     "smooth": dict(beta=1.0, reduction="mean"),
                     "scaled": dict(beta=0.0, loss_scale=0.5, reduction="mean"),
                     "sum": dict(beta=0.5, reduction="sum")}.items():
        np.testing.assert_allclose(float(Data2VecLoss(**kw)(x, y)), float(ref[f"d2v_{name}"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(Data2VecLoss(beta=0.0)(x, y).numpy(), ref["d2v_none"], rtol=1e-5)
    ema = ExponentialMovingAverage(ema_decay=0.9, ema_end_decay=0.999, ema_anneal_end_step=100)
    for n, expected in zip([0, 10, 50, 100], ref["ema_rates"]):
        np.testing.assert_allclose(ema.get_annealed_rate(n), expected, rtol=1e-6)


def test_ijepa_target_pipeline_matches_the_recorded_reference():
    """The task's standardise, gather, repeat and smooth-L1 on the recorded
    reference tensors of ``reference_ijepa_targets.npz``, at the JAX
    package's tolerances (test_reference_parity.py:112-149): targets atol
    2e-5, loss rtol 1e-5."""
    fx = np.load(os.path.join(FIXTURES, "reference_ijepa_targets.npz"))
    h = torch.from_numpy(fx["h"])
    idx = np.stack([np.stack([np.nonzero(row)[0] for row in m]) for m in fx["pred_masks"]])
    target = repeat_interleave_batch(
        apply_masks(standardize(h, 1e-5), torch.from_numpy(idx)), h.shape[0], int(fx["n_enc"]))
    np.testing.assert_allclose(target.numpy(), fx["target"], atol=2e-5)
    loss = smooth_l1(torch.from_numpy(fx["z"]), target, beta=1.0).mean()
    np.testing.assert_allclose(float(loss), float(fx["loss"]), rtol=1e-5)


# ------------------------------------------------------------ the whole step


@functools.lru_cache(maxsize=2)
def _tiny_jax(scan_blocks):
    """The tiny JAX task with params (the modules' own init, drawn once) and
    a teacher apart from the student."""
    jtask = JIJEPA(encoder=JVision(**TINY_ENCODER, scan_blocks=scan_blocks),
                   predictor=JPredictor(**TINY_PREDICTOR))
    masks = _masks(1)
    images = jnp.zeros((1, 64, 64, 3))
    z = jnp.zeros((1, masks["encoder_masks"].shape[-1], 32))
    params = {
        "encoder": jax.jit(jtask.encoder.init)(jax.random.key(0), images)["params"],
        "predictor": jax.jit(jtask.predictor.init)(
            jax.random.key(1), z, masks["encoder_masks"], masks["predictor_masks"])["params"],
    }
    extras = jtask.init_extras(params)
    extras["ema_encoder"] = _noisy(extras["ema_encoder"], 0.05, seed=3)
    return jtask, params, extras


def _tiny_pair(scan_blocks=False, n_batch=4):
    """The tiny JAX task with params, a teacher apart from the student, and a
    batch with its masks, and its port loaded through the bridge."""
    jtask, params, extras = _tiny_jax(scan_blocks)
    jtask.prepare_seed = 0
    batch = jtask.prepare_batch({"rgb": _images(n_batch)}, step=0)
    extras = dict(extras)
    task = IJEPA(VisionTransformer(**TINY_ENCODER),
                 VisionTransformerPredictor(**TINY_PREDICTOR))
    task.load_state_dict(bridge.ijepa_jax_to_torch(jax.device_get(params),
                                                   jax.device_get(extras)), strict=True)
    return jtask, params, extras, batch, task


def test_loss_and_gradients_match_jax_value_and_grad():
    """One ``IJEPA.loss_fn`` and its gradient in every student and predictor
    tensor against ``jax.value_and_grad`` of the JAX task's loss, from the
    same weights and masks; f32: loss and every gradient to atol 1e-5."""
    jtask, params, extras, batch, task = _tiny_pair()

    def jloss(p):
        return jtask.loss_fn(p, batch, jax.random.key(1), extras, deterministic=True)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    loss, metrics = task.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5)
    assert float(metrics["loss"]) == float(loss.detach())
    want = bridge.jax_to_torch(jax.device_get(want_grads))
    got = {n: p.grad for n, p in task.named_parameters() if p.requires_grad}
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name] is not None, name
        torch.testing.assert_close(got[name], g, rtol=0, atol=1e-5, msg=name)
    assert all(p.grad is None for p in task.teacher.parameters())


def test_prepare_batch_matches_jax():
    jtask, _, _, _, task = _tiny_pair()
    for seed, step, training in ((0, 0, True), (7, 3, True), (7, 3, False)):
        jtask.prepare_seed = task.prepare_seed = seed
        want = jtask.prepare_batch({"rgb": _images(5)}, step, training)
        got = task.prepare_batch({"rgb": _images(5)}, step, training)
        for key in (ENCODER_MASK_KEY, PREDICTOR_MASK_KEY):
            np.testing.assert_array_equal(got[key], want[key])
    masked = dict(got)
    assert task.prepare_batch(masked, 9) is masked  # masks given: left as they are


def test_post_update_matches_jax_ema_step():
    """The teacher after one ``post_update`` against the JAX task's, from
    the same student, teacher and step; f32: rtol 1e-6."""
    jtask, params, extras, _, task = _tiny_pair()
    want = jax.jit(jtask.post_update)(params, extras, jnp.asarray(5))
    task.post_update(5)
    got = {k.removeprefix("teacher."): v for k, v in task.state_dict().items()
           if k.startswith("teacher.")}
    for name, value in bridge.jax_to_torch(jax.device_get(want["ema_encoder"])).items():
        torch.testing.assert_close(got[name], value, rtol=1e-6, atol=1e-7, msg=name)


# ------------------------------------------------------------ trajectory


def test_trainer_fit_matches_recorded_reference_trajectory():
    """``Trainer.fit`` over the 30 recorded steps, replaying the recorded
    masks, from the recorded reference weights converted by the JAX
    package's ``hf_utils`` and carried across by the bridge; ``ema_decay=0``
    as the JAX package's own trajectory test
    (tests/tasks/test_training_trajectory.py:161-269), held to its
    tolerances: rtol 1e-5 at step 0, 3e-4 over the first 10, 5e-3 over all
    30."""
    from mmlearn_tpu.hf_utils import convert_ijepa_predictor, convert_ijepa_vit

    c = IJEPA_TRAJ
    fx = np.load(IJEPA_FIXTURE)

    def state(prefix):
        return {k[len(prefix):]: fx[k] for k in fx.files
                if k.startswith(prefix) and not k.startswith(prefix + "masks_")}

    params = {
        "encoder": convert_ijepa_vit(state("enc_"), c["depth"], c["num_heads"]),
        "predictor": convert_ijepa_predictor(state("pred_"), c["pred_depth"], c["num_heads"]),
    }
    enc_masks = [_binary_masks_to_indices(fx[f"enc_masks_{s}"], c["batch"])
                 for s in range(c["steps"])]
    pred_masks = [_binary_masks_to_indices(fx[f"pred_masks_{s}"], c["batch"])
                  for s in range(c["steps"])]

    class ReplayIJEPA(IJEPA):
        def prepare_batch(self, batch, step, training=True):
            batch = dict(batch)
            batch[ENCODER_MASK_KEY] = enc_masks[min(step, c["steps"] - 1)]
            batch[PREDICTOR_MASK_KEY] = pred_masks[min(step, c["steps"] - 1)]
            return batch

    task = ReplayIJEPA(
        VisionTransformer(img_size=c["img"], patch_size=c["patch"], embed_dim=c["embed_dim"],
                          depth=c["depth"], num_heads=c["num_heads"], norm_eps=1e-5),
        VisionTransformerPredictor(
            num_patches=(c["img"] // c["patch"]) ** 2, embed_dim=c["embed_dim"],
            predictor_embed_dim=c["pred_embed_dim"], depth=c["pred_depth"],
            num_heads=c["num_heads"], norm_eps=1e-5),
        optimizer=functools.partial(torch.optim.AdamW, betas=c["betas"], eps=c["eps"],
                                    weight_decay=c["weight_decay"]),
        lr_scheduler=functools.partial(
            linear_warmup_cosine_annealing_lr, base_lr=c["lr"],
            warmup_steps=c["warmup_steps"], max_steps=c["steps"],
            start_factor=c["start_factor"], eta_min=c["eta_min"]),
        # the reference's teacher is a copy of the student (see the JAX test)
        ema_decay=0.0, ema_decay_end=0.0, ema_anneal_end_step=c["ema_anneal_end_step"],
    )
    task.load_state_dict(bridge.ijepa_jax_to_torch(params), strict=True)
    images = make_ijepa_data()
    batches = [{"rgb": np.transpose(images[i], (0, 2, 3, 1))} for i in range(c["n_batches"])]
    trainer = Trainer(max_steps=c["steps"], log_every_n_steps=10, device="cpu")
    state = trainer.fit(task, batches)
    assert state.step == c["steps"]
    got = np.array([h["loss"] for h in trainer.history])
    want = fx["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[:10], want[:10], rtol=3e-4)
    np.testing.assert_allclose(got, want, rtol=5e-3)


# ----------------------------------------------------- bridge, entry points


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["per_layer", "scanned"])
def test_bridge_carries_a_whole_ijepa_tree(scan_blocks):
    """Student, predictor and teacher load with ``strict=True`` and come back
    as the JAX task's flat per-layer paths, the teacher under
    ``ema_encoder/``."""
    jtask, params, extras, _, task = _tiny_pair(scan_blocks)
    back_params, back_extras = bridge.ijepa_torch_to_jax(task)
    if not scan_blocks:
        want_p = bridge.flatten(jax.device_get(params))
        want_e = bridge.flatten({"ema_encoder": jax.device_get(extras["ema_encoder"])})
        for want, back in ((want_p, back_params), (want_e, back_extras)):
            assert set(back) == set(want)
            for path, arr in want.items():
                np.testing.assert_array_equal(back[path], arr, err_msg=path)
    again = IJEPA(VisionTransformer(**TINY_ENCODER), VisionTransformerPredictor(**TINY_PREDICTOR))
    again.load_state_dict(bridge.ijepa_jax_to_torch(back_params, back_extras), strict=True)
    for (name, a), (_, b) in zip(task.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_entry_points_default_to_the_card():
    for fn in (ijepa_training_task, ijepa_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_teacher_is_frozen_outside_the_optimizer_and_in_eval():
    task = IJEPA(VisionTransformer(**TINY_ENCODER), VisionTransformerPredictor(**TINY_PREDICTOR),
                 optimizer=functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4))
    opt, _ = task.configure_optimizers()
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert not any(id(p) in in_opt for p in task.teacher.parameters())
    assert all(not p.requires_grad for p in task.teacher.parameters())
    student = {id(p) for p in [*task.encoder.parameters(), *task.predictor.parameters()]}
    assert in_opt == student
    task.train()
    assert task.encoder.training and not task.teacher.training
    # weights start as the student's
    for (n, a), (_, b) in zip(task.encoder.state_dict().items(),
                              task.teacher.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_trunc_normal_init_is_cut_at_two_std():
    task = IJEPA(VisionTransformer(**TINY_ENCODER, generator=torch.Generator().manual_seed(0)),
                 VisionTransformerPredictor(**TINY_PREDICTOR),
                 generator=torch.Generator().manual_seed(1))
    fc1 = task.encoder.blocks[0].mlp.fc1
    w = fc1.weight.detach()
    assert float(w.abs().max()) <= 0.04 and 0.012 < float(w.std()) < 0.02
    assert float(fc1.bias.detach().abs().max()) == 0.0
    assert float(task.predictor.norm.weight.detach().min()) == 1.0  # norms untouched


def test_trainer_calls_the_hooks_with_the_step_and_seed():
    class Recorder(IJEPA):
        seen: list

        def prepare_batch(self, batch, step, training=True):
            self.seen.append(("prepare", step, self.prepare_seed))
            return super().prepare_batch(batch, step, training)

        def post_update(self, step):
            self.seen.append(("post", step))
            super().post_update(step)

    task = Recorder(VisionTransformer(**TINY_ENCODER), VisionTransformerPredictor(**TINY_PREDICTOR))
    task.seen = []
    before = [p.clone() for p in task.teacher.parameters()]
    Trainer(max_steps=2, device="cpu", seed=5).fit(task, [{"rgb": _images(2)}])
    assert task.seen == [("prepare", 0, 5), ("post", 0), ("prepare", 1, 5), ("post", 1)]
    assert any(not torch.equal(a, b) for a, b in zip(before, task.teacher.parameters()))


def test_ijepa_batch_holds_the_step_zero_masks():
    batch = ijepa_batch(3, torch.Generator().manual_seed(0), device="cpu")
    assert batch["rgb"].shape == (3, 224, 224, 3) and batch["rgb"].dtype == torch.bfloat16
    want = IJEPAMaskGenerator()(3, rng=np.random.default_rng((0, 0, 0)))
    np.testing.assert_array_equal(batch[ENCODER_MASK_KEY].numpy(), want["encoder_masks"])
    np.testing.assert_array_equal(batch[PREDICTOR_MASK_KEY].numpy(), want["predictor_masks"])
