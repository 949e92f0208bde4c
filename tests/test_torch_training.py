"""The training slice of the PyTorch port against the JAX package on the CPU:
the warmup-cosine schedule, the contrastive loss, AdamW with its decay mask,
gradient clipping, the task's loss and the trainer over ten steps of the
tiny CLIP pair, bridged from the JAX init.

Inputs are made from a seed with numpy and fed to both packages in f32.
Each test states its tolerance.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.losses.contrastive import ContrastiveLoss as JLoss
from mmlearn_tpu.modules.losses.contrastive import LossPairSpec as JPair
from mmlearn_tpu.modules.lr_schedulers import linear_warmup_cosine_annealing_lr as jax_schedule
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.tasks.base import decay_mask as jax_decay_mask
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.flagship import (
    VOCAB_SIZE,
    flagship_task,
    flagship_training_task,
    ragged_text_batch,
    synthetic_batch,
)
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.losses import ContrastiveLoss, LossPairSpec
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.serving import EmbeddingIndex
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from mmlearn_tpu_torch.tasks.base import TrainingTask, decay_mask
from mmlearn_tpu_torch.trainer import Trainer
from tests.test_torch_encoders import TINY_TEXT, TINY_VISION, tiny_pair

# ------------------------------------------------------------------ schedule

SCHEDULES = [
    dict(base_lr=1e-3, warmup_steps=100, max_steps=10_000),  # the flagship's
    dict(base_lr=3e-4, warmup_steps=0, max_steps=50, start_factor=0.1, eta_min=1e-5),
    dict(base_lr=2e-3, warmup_steps=7, max_steps=5, start_factor=0.5),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["flagship", "no_warmup", "short"])
def test_schedule_matches_optax_at_every_step(kw):
    """f64 on the host against optax's f32: rtol 1e-5, and 1e-10 absolute
    where the cosine ends near zero and f32 cancels."""
    steps = np.arange(kw["max_steps"] + 10)
    want = np.asarray(jax_schedule(**kw)(jnp.asarray(steps)))
    sched = linear_warmup_cosine_annealing_lr(**kw)
    got = np.array([sched(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)


# ---------------------------------------------------------------------- loss


def _embeddings(mods, b, d, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for m in mods:
        z = rng.standard_normal((b, d)).astype(np.float32)
        out[m] = z / np.linalg.norm(z, axis=1, keepdims=True)
    return out


LOSS_CASES = {
    "pair": dict(mods=("rgb", "text"), loss={}),
    "three_presence": dict(mods=("rgb", "text", "audio"), loss={}, presence=True),
    "example_ids": dict(mods=("rgb", "text"), loss={}, example_ids=True),
    "chunked": dict(mods=("rgb", "text", "audio"), loss=dict(chunked=True, chunk_size=4),
                    presence=True),
    "alignment": dict(mods=("rgb", "text", "audio"), loss=dict(modality_alignment=True),
                      presence=True, example_ids=True),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_contrastive_loss_and_gradient_match_jax(case):
    """Loss, per-pair metrics and gradients in the embeddings and the scale;
    f32, sums in another order: atol 1e-5."""
    c = LOSS_CASES[case]
    b = 10  # not a multiple of the chunk
    emb = _embeddings(c["mods"], b, 8, seed=1)
    rng = np.random.default_rng(2)
    presence = ({m: rng.random(b) > 0.25 for m in c["mods"]} if c.get("presence")
                else None)
    ids = None
    if c.get("example_ids"):
        ids = {}
        for m in c["mods"]:
            e = np.stack([np.zeros(b, np.int64), np.arange(b)], 1)
            e[rng.random(b) < 0.2] = -1
            ids[m] = e
    pairs = [(a, bb) for i, a in enumerate(c["mods"]) for bb in c["mods"][i + 1:]]
    scale = np.float32(14.3)

    jloss = JLoss(**c["loss"])
    jpairs = [JPair(p, weight=1.0 + k) for k, p in enumerate(pairs)]

    def jfn(e, s):
        return jloss(e, ids, s, jpairs, presence=presence)

    (want, wmetrics), wgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in emb.items()}, jnp.asarray(scale))

    t_emb = {k: torch.from_numpy(v).requires_grad_() for k, v in emb.items()}
    t_scale = torch.tensor(scale, requires_grad=True)
    got, metrics = ContrastiveLoss(**c["loss"])(
        t_emb, None if ids is None else {k: torch.from_numpy(v) for k, v in ids.items()},
        t_scale, [LossPairSpec(p, weight=1.0 + k) for k, p in enumerate(pairs)],
        presence=None if presence is None else {k: torch.from_numpy(v)
                                                for k, v in presence.items()},
    )
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5)
    assert set(metrics) == set(wmetrics)
    for k in wmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(wmetrics[k]), atol=1e-5)
    got.backward()
    for m in emb:
        np.testing.assert_allclose(t_emb[m].grad.numpy(), np.asarray(wgrads[0][m]), atol=1e-5)
    np.testing.assert_allclose(float(t_scale.grad), float(wgrads[1]), atol=1e-5)


# ------------------------------------------------------------ AdamW, clipping


class _Affine(TrainingTask):
    """A 2-D weight (decayed), a bias and a scalar (not decayed), and a
    quadratic loss of a fixed input."""

    def __init__(self, **kw):
        super().__init__(**kw)
        rng = np.random.default_rng(0)
        self.proj = nn.Linear(6, 4)
        with torch.no_grad():
            self.proj.weight.copy_(torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)))
            self.proj.bias.copy_(torch.from_numpy(rng.standard_normal(4).astype(np.float32)))
        self.scale = nn.Parameter(torch.tensor(0.5))

    def loss_fn(self, batch):
        loss = (self.proj(torch.as_tensor(batch["x"])) * self.scale).square().mean()
        return loss, {"loss": loss.detach()}

    def jax_params(self):
        return {"proj": {"weight": self.proj.weight.detach().numpy().copy(),
                         "bias": self.proj.bias.detach().numpy().copy()},
                "scale": self.scale.detach().numpy().copy()}


def _jax_affine_loss(p, x):
    return jnp.mean(jnp.square((x @ p["proj"]["weight"].T + p["proj"]["bias"]) * p["scale"]))


def _assert_params_match(task, params, **tol):
    np.testing.assert_allclose(task.proj.weight.detach().numpy(), params["proj"]["weight"], **tol)
    np.testing.assert_allclose(task.proj.bias.detach().numpy(), params["proj"]["bias"], **tol)
    np.testing.assert_allclose(task.scale.detach().numpy(), params["scale"], **tol)


def test_decay_mask_matches_jax():
    task = _Affine()
    want = jax_decay_mask(task.jax_params())
    assert decay_mask(task) == {"proj.weight": bool(want["proj"]["weight"]),
                                "proj.bias": bool(want["proj"]["bias"]),
                                "scale": bool(want["scale"])}


def test_adamw_matches_optax_with_decay_mask():
    """torch's AdamW and optax's adamw are one update: decoupled decay times
    lr (only where ndim >= 2) and bias-corrected moments. Three steps from
    the same parameters and gradients; f32 rounding: rtol 1e-6."""
    task = _Affine(optimizer=functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=0.1))
    opt, sched = task.configure_optimizers()
    assert sched is None
    params = task.jax_params()
    tx = optax.adamw(1e-2, weight_decay=0.1, mask=jax_decay_mask)
    state = tx.init(params)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
                             params)
        task.proj.weight.grad = torch.from_numpy(grads["proj"]["weight"])
        task.proj.bias.grad = torch.from_numpy(grads["proj"]["bias"])
        task.scale.grad = torch.from_numpy(grads["scale"])
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        _assert_params_match(task, params, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("algorithm,clip", [("norm", 0.5), ("value", 0.05), ("norm", None)])
def test_trainer_step_matches_optax_chain(algorithm, clip):
    """Trainer steps (global norm before clipping, clip, AdamW, schedule)
    against optax's chain of the same; rtol 1e-5 (f32, a few steps)."""
    kw = dict(base_lr=1e-2, warmup_steps=2, max_steps=6)
    task = _Affine(optimizer=functools.partial(torch.optim.AdamW, weight_decay=0.01),
                   lr_scheduler=functools.partial(linear_warmup_cosine_annealing_lr, **kw))
    params = task.jax_params()
    x = np.random.default_rng(4).standard_normal((5, 6)).astype(np.float32)
    trainer = Trainer(max_steps=6, log_every_n_steps=4, gradient_clip_val=clip,
                      gradient_clip_algorithm=algorithm, device="cpu")
    trainer.fit(task, [{"x": x}])

    schedule = jax_schedule(**kw)
    chain = [optax.adamw(schedule, weight_decay=0.01, mask=jax_decay_mask)]
    if clip:
        chain.insert(0, optax.clip_by_global_norm(clip) if algorithm == "norm"
                     else optax.clip(clip))
    tx = optax.chain(*chain)
    state = tx.init(params)
    assert [h["step"] for h in trainer.history] == list(range(6))
    for i, rec in enumerate(trainer.history):
        loss, grads = jax.value_and_grad(_jax_affine_loss)(params, x)
        np.testing.assert_allclose(rec["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(rec["grad_norm"], float(optax.global_norm(grads)), rtol=1e-5)
        np.testing.assert_allclose(rec["lr"], float(schedule(i)), rtol=1e-5)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    _assert_params_match(task, params, rtol=1e-5, atol=1e-6)


def test_lambda_lr_gives_the_schedule_each_step():
    kw = dict(base_lr=1e-3, warmup_steps=3, max_steps=10)
    task = _Affine(lr_scheduler=functools.partial(linear_warmup_cosine_annealing_lr,
                                                  base_lr=1e-3, warmup_steps=3))
    opt, sched = task.configure_optimizers(max_steps=10)  # max_steps filled in
    want = linear_warmup_cosine_annealing_lr(**kw)
    for step in range(12):
        assert [g["lr"] for g in opt.param_groups] == pytest.approx([want(step)] * 2)
        opt.step()
        sched.step()


# ------------------------------------------------------------ the whole slice

STEPS = 10


def _tiny_batches():
    rng = np.random.default_rng(0)
    batches = []
    for i in range(2):
        ids = rng.integers(1, 30, (4, 8)).astype(np.int32)
        ids[:, -1] = 31  # end of text: the row maximum
        batches.append({"rgb": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
                        "text": ids})
    # the second batch drops a padded row and one absent caption
    batches[1]["batch_validity"] = np.array([True, True, True, False])
    batches[1]["text_presence"] = np.array([True, False, True, True])
    return batches


def _training_pair():
    jtask = JTask(
        encoders={"rgb": JVision(**TINY_VISION), "text": JText(**TINY_TEXT)},
        optimizer=functools.partial(optax.adamw, weight_decay=0.01),
        lr_scheduler=functools.partial(jax_schedule, base_lr=1e-3, warmup_steps=3),
    )
    batches = _tiny_batches()
    params = jtask.init_params(jax.random.key(0), batches[0])
    ptask = ContrastivePretraining(
        {"rgb": VisionTransformer(**TINY_VISION), "text": TextTransformer(**TINY_TEXT)},
        optimizer=functools.partial(torch.optim.AdamW, weight_decay=0.01),
        lr_scheduler=functools.partial(linear_warmup_cosine_annealing_lr, base_lr=1e-3,
                                       warmup_steps=3),
    )
    ptask.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)
    return jtask, params, batches, ptask


def test_trainer_fit_matches_jax_train_loop():
    """Ten steps of the tiny CLIP pair through ``Trainer.fit`` against the
    JAX ``value_and_grad`` + ``tx.update`` loop of ``bench.py``'s train step,
    from the same (bridged) weights. Tolerances of the JAX package's own
    trajectory test (tests/tasks/test_training_trajectory.py:647-652): loss
    rtol 1e-5 at step 0 and 3e-4 over the steps, lr 1e-4, logit scale 5e-3;
    the gradient norm to 1e-3."""
    jtask, params, batches, ptask = _training_pair()
    tx = jtask.configure_optimizers(max_steps=STEPS)
    opt_state = tx.init(params)
    rng = jax.random.key(1)

    @jax.jit
    def train_step(params, opt_state, batch):
        def loss_wrap(p):
            loss, (metrics, _) = jtask.loss_fn(p, batch, rng, {}, deterministic=False)
            return loss, metrics

        (loss, metrics), grads = jax.value_and_grad(loss_wrap, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss,
                metrics["logit_scale"], optax.global_norm(grads))

    want = {"loss": [], "logit_scale": [], "grad_norm": []}
    for i in range(STEPS):
        params, opt_state, loss, scale, gnorm = train_step(params, opt_state,
                                                           batches[i % 2])
        for k, v in zip(want, (loss, scale, gnorm)):
            want[k].append(float(v))

    trainer = Trainer(max_steps=STEPS, log_every_n_steps=1, device="cpu")
    state = trainer.fit(ptask, batches)
    assert state.step == STEPS and len(trainer.history) == STEPS
    got = {k: np.array([h[k] for h in trainer.history])
           for k in ("loss", "lr", "logit_scale", "grad_norm")}
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=3e-4)
    np.testing.assert_allclose(got["lr"], np.asarray(jtask._resolved_schedule(np.arange(STEPS))),
                               rtol=1e-4)
    np.testing.assert_allclose(got["logit_scale"], want["logit_scale"], rtol=5e-3)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3)


def test_task_rejects_unported_options():
    towers = {"rgb": VisionTransformer(**TINY_VISION)}
    # auxiliary tasks are ported (tests/test_torch_multitask.py); a spec of
    # another type is refused
    with pytest.raises(TypeError, match="AuxiliaryTaskSpec"):
        ContrastivePretraining(towers, auxiliary_tasks={"a": object()})
    # PEFT and frozen encoders are ported (tests/test_torch_peft.py holds them
    # to the JAX task): a LoRA'd tower trains only its factors, a frozen one
    # nothing
    lora = ContrastivePretraining({"rgb": VisionTransformer(**TINY_VISION)},
                                  peft_configs={"rgb": {}})
    assert {n for n, p in lora.named_parameters() if p.requires_grad} == {
        n for n, _ in lora.named_parameters() if n.startswith("lora.")} | {"log_logit_scale"}
    frozen = ContrastivePretraining(towers, freeze_encoders={"rgb": True})
    assert not any(p.requires_grad for p in frozen.encoders.parameters())
    with pytest.raises(ValueError, match="unknown modality"):
        ContrastivePretraining(towers, modality_loss_pairs=[{"modalities": ["rgb", "text"]}])


def test_logit_scale_is_clamped_and_can_be_frozen():
    towers = {"rgb": VisionTransformer(**TINY_VISION), "text": TextTransformer(**TINY_TEXT)}
    task = ContrastivePretraining(towers, init_logit_scale=500.0, learnable_logit_scale=False)
    assert float(task.logit_scale()) == pytest.approx(100.0)
    assert not task.log_logit_scale.requires_grad
    opt, _ = task.configure_optimizers()
    assert all(p is not task.log_logit_scale for g in opt.param_groups for p in g["params"])
    assert [p.modalities for p in task.modality_loss_pairs] == [("rgb", "text")]


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["per_layer", "scanned"])
def test_bridge_carries_the_whole_task_tree(scan_blocks):
    """A JAX task tree (encoders and ``log_logit_scale``) loads into the
    port's task with ``strict=True`` and comes back as the same flat paths."""
    jtask, params, _, _ = tiny_pair(scan_blocks)
    task = ContrastivePretraining({"rgb": VisionTransformer(**TINY_VISION),
                                   "text": TextTransformer(**TINY_TEXT)})
    task.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)
    assert task.log_logit_scale.item() == pytest.approx(float(params["log_logit_scale"]))
    back = bridge.torch_to_jax(task)
    assert "log_logit_scale" in back
    again = ContrastivePretraining({"rgb": VisionTransformer(**TINY_VISION),
                                    "text": TextTransformer(**TINY_TEXT)})
    again.load_state_dict(bridge.jax_to_torch(back), strict=True)
    for (name, a), (_, b) in zip(task.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_entry_points_default_to_the_card():
    for fn in (EmbeddingIndex.__init__, EmbeddingIndex.load, Trainer.__init__,
               flagship_task, flagship_training_task, synthetic_batch, ragged_text_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_synthetic_batch_matches_the_flagship_contract():
    batch = synthetic_batch(3, torch.Generator().manual_seed(0), device="cpu")
    assert batch["rgb"].shape == (3, 224, 224, 3) and batch["rgb"].dtype == torch.bfloat16
    ids = batch["text"]
    assert ids.shape == (3, 77) and ids.dtype == torch.int32
    assert bool((ids[:, :-1] >= 2).all()) and bool((ids[:, :-1] <= VOCAB_SIZE - 2).all())
    assert bool((ids[:, -1] == VOCAB_SIZE - 1).all())
    assert set(batch) == {"rgb", "text"}  # no padding mask


def test_ragged_text_batch_pads_on_the_right():
    batch = ragged_text_batch(64, torch.Generator().manual_seed(0), device="cpu")
    ids, mask = batch["text"], batch["text_attention_mask"]
    assert ids.shape == mask.shape == (64, 77) and ids.dtype == mask.dtype == torch.int32
    lens = mask.sum(1)
    assert bool((lens >= 2).all()) and int(lens.min()) < int(lens.max())
    assert bool((mask[:, :-1] >= mask[:, 1:]).all())  # ones, then zeros
    eos = ids.gather(1, (lens - 1)[:, None].long())
    assert bool((eos == VOCAB_SIZE - 1).all())
    assert bool((ids == VOCAB_SIZE - 1).sum(1).eq(1).all())  # EOS is each row's maximum
    assert bool((ids[mask == 0] == 0).all()) and bool((ids[mask == 1] >= 1).all())


# ------------------------------------------------------------------ the card

CUDA_VISION = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
                   use_cls_token=True, global_pool="cls", proj_dim=16)
CUDA_TEXT = dict(vocab_size=64, max_length=16, embed_dim=128, depth=2, num_heads=2,
                 causal=True, pooling="eos", proj_dim=16)


@pytest.mark.cuda
def test_cuda_trainer_matches_cpu():
    """Three f32 steps through the kernels on the card against the plain
    versions on the CPU, from the same weights: the kernels differ by f32
    summation order, rtol 1e-4 on the loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 62, (4, 16)).astype(np.int32)
    ids[:, -1] = 63
    batch = {"rgb": rng.standard_normal((4, 32, 32, 3)).astype(np.float32), "text": ids}
    histories = []
    for device in ("cpu", "cuda"):
        g = torch.Generator().manual_seed(0)
        task = ContrastivePretraining(
            {"rgb": VisionTransformer(**CUDA_VISION, generator=g),
             "text": TextTransformer(**CUDA_TEXT, generator=g)},
            optimizer=functools.partial(torch.optim.AdamW, lr=1e-3))
        trainer = Trainer(max_steps=3, device=device)
        trainer.fit(task, [batch])
        histories.append(trainer.history)
    for cpu, gpu in zip(*histories):
        assert gpu["loss"] == pytest.approx(cpu["loss"], rel=1e-4)
