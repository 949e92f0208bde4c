"""The multi-task composition of the PyTorch port against the JAX package on
the CPU: ``ContrastivePretraining`` with an I-JEPA auxiliary task on the
shared rgb tower (the ``projects/multi_task`` experiment), its loss and
every gradient against ``jax.value_and_grad``, the auxiliary teacher's EMA
step, the decay mask by name, the run seed reaching the auxiliary masks,
the EMA step offset through a state dict, a checkpoint and an import, a
resumed run bit-equal to the whole one, and ``Trainer.fit`` over the 30
steps of the recorded reference trajectory.

Weights cross through ``mmlearn_tpu_torch.bridge``; inputs are made from a
seed with numpy and fed to both packages in f32. Each test states its
tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.modules.encoders.vision import VisionTransformer as JVision
from mmlearn_tpu.modules.encoders.vision import VisionTransformerPredictor as JPredictor
from mmlearn_tpu.tasks import AuxiliaryTaskSpec as JAuxSpec
from mmlearn_tpu.tasks import ContrastivePretraining as JContrastive
from mmlearn_tpu.tasks import IJEPA as JIJEPA
from mmlearn_tpu.tasks.base import decay_mask as j_decay_mask
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import VisionTransformer, VisionTransformerPredictor
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.tasks import IJEPA, ContrastivePretraining
from mmlearn_tpu_torch.tasks.contrastive_pretraining import AuxiliaryTaskSpec
from mmlearn_tpu_torch.tasks.ijepa import ENCODER_MASK_KEY, PREDICTOR_MASK_KEY
from mmlearn_tpu_torch.trainer import ModelCheckpoint, Trainer
from tests.tasks.test_training_trajectory import (
    MT_FIXTURE,
    MT_TRAJ,
    _binary_masks_to_indices,
    make_multitask_data,
)
from tests.test_torch_reference_fixtures import MLPEncoder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny models of this file: under a
    parallel test run, several workers' thread pools on the same cores slow
    such steps many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-5  # f32 end to end; sums in another order (tests/test_torch_ijepa.py's)
AUX_WEIGHT = 0.3
# the towers of contrastive_ijepa.yaml cut to 2 blocks of width 32 at 64 px,
# pooled by mean: the JAX I-JEPA raises on a tower with a cls token (the
# port takes its patch tokens; test_cls_token_tower_takes_the_patch_tokens)
TOWER = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4,
             global_pool="avg", proj_dim=16)
PREDICTOR = dict(num_patches=16, embed_dim=32, predictor_embed_dim=16, depth=1, num_heads=4)


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.standard_normal((b, 64, 64, 3)).astype(np.float32),
            "depth": rng.standard_normal((b, 64, 64, 1)).astype(np.float32)}


def _noisy(tree, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(tree))


def _port_task(**kw):
    return ContrastivePretraining(
        {"rgb": VisionTransformer(**TOWER), "depth": VisionTransformer(**TOWER, in_chans=1)},
        auxiliary_tasks={"ijepa_rgb": AuxiliaryTaskSpec(
            "rgb", functools.partial(IJEPA, predictor=VisionTransformerPredictor(**PREDICTOR)),
            AUX_WEIGHT)},
        log_auxiliary_tasks_loss=True, **kw)


@functools.lru_cache(maxsize=1)
def _jax_task():
    """The tiny JAX task, its params (the modules' own init) and extras
    with a teacher apart from the student."""
    jtask = JContrastive(
        encoders={"rgb": JVision(**TOWER), "depth": JVision(**TOWER, in_chans=1)},
        auxiliary_tasks={"ijepa_rgb": JAuxSpec(
            modality="rgb", task=functools.partial(JIJEPA, predictor=JPredictor(**PREDICTOR)),
            loss_weight=AUX_WEIGHT)},
        log_auxiliary_tasks_loss=True)
    params = jax.device_get(jtask.init_params(jax.random.key(0), _batch(2)))
    extras = jax.device_get(jtask.init_extras(params))
    extras["ijepa_rgb"]["ema_encoder"] = _noisy(extras["ijepa_rgb"]["ema_encoder"], 0.05, 3)
    return jtask, params, extras


def _pair(n_batch=4):
    jtask, params, extras = _jax_task()
    jtask.prepare_seed = 0
    batch = jtask.prepare_batch(_batch(n_batch, seed=1), step=0)
    task = _port_task()
    task.load_state_dict(bridge.task_jax_to_torch(params, extras), strict=True)
    return jtask, params, extras, batch, task


def test_loss_and_every_gradient_match_jax_value_and_grad():
    """The contrastive loss plus 0.3 x the auxiliary I-JEPA loss and the
    gradient of every trained tensor (the shared rgb tower takes both
    objectives; the predictor's; the depth tower's; the logit scale)
    against ``jax.value_and_grad`` of the JAX task from the same weights and
    masks; f32: loss, the logged aux loss and every gradient to atol 1e-5."""
    jtask, params, extras, batch, task = _pair()

    def jloss(p):
        loss, (metrics, _) = jtask.loss_fn(p, batch, jax.random.key(1), extras,
                                           deterministic=True)
        return loss, metrics

    (want_loss, want_metrics), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    loss, metrics = task.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(float(metrics["aux_ijepa_rgb_loss"]),
                               float(want_metrics["aux_ijepa_rgb_loss"]), atol=ATOL)
    assert float(metrics["loss"]) == float(loss.detach())
    want = {k: v for k, v in bridge.task_jax_to_torch(jax.device_get(want_grads)).items()
            if torch.is_tensor(v)}
    got = {n: p.grad for n, p in task.named_parameters() if p.requires_grad}
    assert set(got) == set(want)
    assert any(n.startswith("auxiliary_tasks.ijepa_rgb.predictor.") for n in got)
    for name, g in want.items():
        assert got[name] is not None, name
        torch.testing.assert_close(got[name], g, rtol=0, atol=ATOL, msg=name)
    teacher = task.auxiliary_tasks["ijepa_rgb"].teacher
    assert all(p.grad is None for p in teacher.parameters())


def test_aux_post_update_matches_jax():
    """The teacher after one ``post_update`` against the JAX task's
    ``aux_post_update``, from the same student, teacher and step; f32:
    rtol 1e-6 (tests/test_torch_ijepa.py's)."""
    jtask, params, extras, _, task = _pair()
    want = jax.jit(jtask.post_update)(params, extras, jnp.asarray(5))
    task.post_update(5)
    got = {k.removeprefix("auxiliary_tasks.ijepa_rgb.teacher."): v
           for k, v in task.state_dict().items()
           if k.startswith("auxiliary_tasks.ijepa_rgb.teacher.")}
    for name, value in bridge.jax_to_torch(
            jax.device_get(want["ijepa_rgb"]["ema_encoder"])).items():
        torch.testing.assert_close(got[name], value, rtol=1e-6, atol=1e-7, msg=name)


def test_optimizer_groups_hold_the_jax_decay_mask_by_name():
    """Each trained tensor enters the optimizer once, in the group the JAX
    decay mask puts it in (the shared tower once, under ``encoders``; the
    predictor under the JAX ``params["aux"]``); the teacher in none."""
    _, params, extras, _, task = _pair()
    jmask = {k: bool(v) for k, v in bridge.flatten(j_decay_mask(params)).items()}
    paths = bridge.jax_paths(task)
    opt, _ = task.configure_optimizers()
    decayed, plain = ({id(p) for p in g["params"]} for g in opt.param_groups)
    ids = [id(p) for g in opt.param_groups for p in g["params"]]
    assert len(ids) == len(set(ids))
    names = {id(p): n for n, p in task.named_parameters()}
    assert len(ids) == len(jmask)
    for pid in ids:
        path = paths[names[pid]].replace("auxiliary_tasks/", "aux/", 1)
        assert jmask[path] == (pid in decayed), path
    teacher = {id(p) for p in task.auxiliary_tasks["ijepa_rgb"].teacher.parameters()}
    assert not teacher & (decayed | plain)
    shared = task.encoders["rgb"]
    assert task.auxiliary_tasks["ijepa_rgb"].encoder is shared
    assert not any(k.startswith("auxiliary_tasks.ijepa_rgb.encoder.") for k in task.state_dict())


def test_bridge_round_trip_is_exact():
    """``task_torch_to_jax`` gives back the JAX params and extras (the EMA
    offset included) bit for bit."""
    _, params, extras, _, task = _pair()
    back_params, back_extras = bridge.task_torch_to_jax(task)
    want_p = bridge.flatten(params)
    want_e = bridge.flatten(extras)
    assert set(back_params) == set(want_p) and set(back_extras) == set(want_e)
    for want, back in ((want_p, back_params), (want_e, back_extras)):
        for path, arr in want.items():
            np.testing.assert_array_equal(back[path], arr, err_msg=path)


@pytest.mark.parametrize("seed", [0, 7])
def test_run_seed_reaches_the_aux_mask_generator(seed):
    """The parent's ``prepare_seed`` (the trainer's seed) draws the
    auxiliary task's masks, as the JAX task forwards it; the draws equal the
    JAX ones and differ between seeds."""
    jtask, _, _, _, task = _pair()
    jtask.prepare_seed = task.prepare_seed = seed
    want = jtask.prepare_batch(_batch(5), 3)
    got = task.prepare_batch(_batch(5), 3)
    for key in (ENCODER_MASK_KEY, PREDICTOR_MASK_KEY):
        np.testing.assert_array_equal(got[key], want[key])
    task.prepare_seed = seed + 1
    other = task.prepare_batch(_batch(5), 3)
    assert not np.array_equal(other[ENCODER_MASK_KEY], got[ENCODER_MASK_KEY])
    trainer = Trainer(max_steps=1, seed=seed, device="cpu")
    trainer.fit(task, [_batch(2)])
    assert task.auxiliary_tasks["ijepa_rgb"].prepare_seed == seed


def test_ema_offset_survives_state_dict_import_and_bridge():
    """``apply_import_metadata`` sets the auxiliary offset; it travels in the
    state dict (``_extra_state``), the JAX extras and back, and sets the
    standalone task's too."""
    task = _port_task()
    task.apply_import_metadata({"ema": {"num_updates": 77}})
    assert task.auxiliary_tasks["ijepa_rgb"].ema_step_offset == 77
    state = task.state_dict()
    assert state["auxiliary_tasks.ijepa_rgb._extra_state"] == {"ema_step_offset": 77}
    fresh = _port_task()
    fresh.load_state_dict(state, strict=True)
    assert fresh.auxiliary_tasks["ijepa_rgb"].ema_step_offset == 77
    params, extras = bridge.task_torch_to_jax(task)
    assert int(extras["ijepa_rgb/ema_step_offset"]) == 77
    again = _port_task()
    again.load_state_dict(bridge.task_jax_to_torch(params, extras), strict=True)
    assert again.auxiliary_tasks["ijepa_rgb"].ema_step_offset == 77
    alone = IJEPA(VisionTransformer(**{**TOWER, "proj_dim": None}))
    alone.apply_import_metadata({"ema": {"num_updates": 5}})
    copy = IJEPA(VisionTransformer(**{**TOWER, "proj_dim": None}))
    copy.load_state_dict(alone.state_dict(), strict=True)
    assert copy.ema_step_offset == 5


def _fit(tmp_path, name, steps, ckpt_path=None, offset=0):
    torch.manual_seed(0)
    task = _port_task()
    task.apply_import_metadata({"ema": {"num_updates": offset}})
    ckpt = ModelCheckpoint(str(tmp_path / "ckpt"), every_n_train_steps=2, every_n_epochs=None,
                           max_to_keep=0, async_save=False)
    batches = [_batch(4, seed=10 + i) for i in range(3)]
    trainer = Trainer(max_steps=steps, log_every_n_steps=1, callbacks=[ckpt], seed=3,
                      device="cpu", default_root_dir=str(tmp_path / name))
    trainer.fit(task, batches, ckpt_path=ckpt_path)
    return trainer.history, task.state_dict()


def test_resumed_multitask_run_is_bit_equal(tmp_path):
    """4 steps in one run against 2 steps, then a fresh task resumed from the
    step-2 checkpoint to 4 (offset 77 set only on the first run): every
    record and every state entry (teacher and offset included) equal."""
    whole, whole_state = _fit(tmp_path / "a", "whole", 4, offset=77)
    _fit(tmp_path / "b", "first", 2, offset=77)
    rest, rest_state = _fit(tmp_path / "b", "rest", 4, ckpt_path=str(tmp_path / "b" / "ckpt"))
    assert rest == whole[2:]
    assert set(rest_state) == set(whole_state)
    assert rest_state["auxiliary_tasks.ijepa_rgb._extra_state"] == {"ema_step_offset": 77}
    for name, value in whole_state.items():
        if torch.is_tensor(value):
            assert torch.equal(rest_state[name], value), name
    assert all("aux_ijepa_rgb_loss" in h for h in whole)


def test_unknown_aux_modality_raises():
    with pytest.raises(ValueError, match="unknown modality 'text'"):
        ContrastivePretraining(
            {"rgb": VisionTransformer(**TOWER), "depth": VisionTransformer(**TOWER, in_chans=1)},
            auxiliary_tasks={"ijepa_text": {"modality": "text", "task": IJEPA}})


def test_cls_token_tower_takes_the_patch_tokens():
    """On the experiment's cls-pooled towers the auxiliary loss is the
    I-JEPA loss of the patch tokens: the student's and the teacher's cls rows
    dropped before the predictor and the target gather."""
    from mmlearn_tpu_torch.modules.encoders.vision import apply_masks, repeat_interleave_batch
    from mmlearn_tpu_torch.modules.losses import smooth_l1
    from mmlearn_tpu_torch.tasks.ijepa import standardize

    cls = {**TOWER, "use_cls_token": True, "global_pool": "cls"}
    torch.manual_seed(0)
    task = ContrastivePretraining(
        {"rgb": VisionTransformer(**cls), "depth": VisionTransformer(**cls, in_chans=1)},
        auxiliary_tasks={"ijepa_rgb": {"modality": "rgb", "task": functools.partial(
            IJEPA, predictor=VisionTransformerPredictor(**PREDICTOR))}})
    aux = task.auxiliary_tasks["ijepa_rgb"]
    batch = task.prepare_batch(_batch(3), 0)
    images = torch.from_numpy(batch["rgb"])
    enc = torch.from_numpy(batch[ENCODER_MASK_KEY]).long()
    pred = torch.from_numpy(batch[PREDICTOR_MASK_KEY]).long()
    with torch.no_grad():
        loss, _ = aux.aux_loss(batch)
        h = standardize(aux.teacher(images).last_hidden_state[:, 1:], 1e-5)
        h = repeat_interleave_batch(apply_masks(h, pred), 3, enc.shape[0])
        z = task.encoders["rgb"](images, patch_masks=enc).last_hidden_state[:, 1:]
        want = smooth_l1(aux.predictor(z, enc, pred), h, 1.0).mean()
    assert torch.isfinite(loss) and float(loss) == float(want)


class MeanTokens(torch.nn.Module):
    def forward(self, x):
        return x.mean(dim=1)


def test_trainer_fit_matches_recorded_multitask_trajectory():
    """``Trainer.fit`` over the 30 recorded steps of the reference's
    multi-task run (the shared ViT, the MLP text tower, the I-JEPA aux at
    weight 0.3, the recorded masks replayed, ``ema_decay=0`` as the JAX
    test), from the recorded weights converted by the JAX package's
    ``hf_utils`` and carried by the bridge, at the JAX test's tolerances
    (tests/tasks/test_training_trajectory.py:443-448): losses rtol 1e-4 at
    step 0, 1e-3 over 10 steps, 1e-2 over 30; logit scales rtol 5e-3."""
    from mmlearn_tpu.hf_utils import convert_ijepa_predictor, convert_ijepa_vit

    fx = np.load(MT_FIXTURE)
    c = MT_TRAJ
    rgb, txt, ids = make_multitask_data()

    def state(prefix):
        return {k[len(prefix):]: fx[k] for k in fx.files
                if k.startswith(prefix) and not k.startswith(prefix + "masks_")}

    enc = bridge.jax_to_torch(convert_ijepa_vit(state("enc_"), c["depth"], c["num_heads"]))
    pred = bridge.jax_to_torch(
        convert_ijepa_predictor(state("pred_"), c["pred_depth"], c["num_heads"]))
    enc_masks = [_binary_masks_to_indices(fx[f"enc_masks_{s}"], c["batch"])
                 for s in range(c["steps"])]
    pred_masks = [_binary_masks_to_indices(fx[f"pred_masks_{s}"], c["batch"])
                  for s in range(c["steps"])]

    class ReplayAuxIJEPA(IJEPA):
        def prepare_batch(self, batch, step, training=True):
            batch = dict(batch)
            batch[ENCODER_MASK_KEY] = enc_masks[min(step, c["steps"] - 1)]
            batch[PREDICTOR_MASK_KEY] = pred_masks[min(step, c["steps"] - 1)]
            return batch

    vit = VisionTransformer(img_size=c["img"], patch_size=c["patch"], embed_dim=c["embed_dim"],
                            depth=c["depth"], num_heads=c["num_heads"], norm_eps=1e-5)
    vit.load_state_dict(enc, strict=True)
    predictor = VisionTransformerPredictor(
        num_patches=(c["img"] // c["patch"]) ** 2, embed_dim=c["embed_dim"],
        predictor_embed_dim=c["pred_embed_dim"], depth=c["pred_depth"],
        num_heads=c["num_heads"], norm_eps=1e-5)
    predictor.load_state_dict(pred, strict=True)
    head = torch.nn.Linear(c["embed_dim"], c["emb"])
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(fx["head_weight"]))
        head.bias.copy_(torch.from_numpy(fx["head_bias"]))
    task = ContrastivePretraining(
        {"rgb": vit, "text": MLPEncoder(fx["txt_fc1.weight"], fx["txt_fc1.bias"],
                                        fx["txt_fc2.weight"], fx["txt_fc2.bias"])},
        heads={"rgb": head}, postprocessors={"rgb": MeanTokens()},
        optimizer=functools.partial(torch.optim.AdamW, betas=c["betas"], eps=c["eps"],
                                    weight_decay=c["weight_decay"]),
        lr_scheduler=functools.partial(
            linear_warmup_cosine_annealing_lr, base_lr=c["lr"], warmup_steps=c["warmup_steps"],
            max_steps=c["steps"], start_factor=c["start_factor"], eta_min=c["eta_min"]),
        auxiliary_tasks={"ijepa_aux": AuxiliaryTaskSpec(
            "rgb", functools.partial(ReplayAuxIJEPA, predictor=predictor, ema_decay=0.0,
                                     ema_decay_end=0.0, ema_anneal_end_step=100),
            c["aux_weight"])},
    )
    batches = [{"rgb": np.transpose(rgb[i], (0, 2, 3, 1)), "text": txt[i],
                "example_ids": {"rgb": ids, "text": ids}} for i in range(c["n_batches"])]
    trainer = Trainer(max_steps=c["steps"], log_every_n_steps=10, device="cpu")
    state = trainer.fit(task, batches)
    assert state.step == c["steps"]
    got = np.array([h["loss"] for h in trainer.history])
    want = fx["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[:10], want[:10], rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    np.testing.assert_allclose([h["logit_scale"] for h in trainer.history],
                               np.exp(fx["log_scales"]), rtol=5e-3)
