"""The port's fit loop on the CPU: gradient accumulation with clipping held
to the JAX ``Trainer`` on the same tiny contrastive task and batches (the
weights bridged from the JAX init), and the loop's behaviours, the
counterparts of ``tests/tasks/test_trainer_behaviors.py`` and
``test_grad_accumulation.py``, held to the same expectations.

Towers of 2 blocks at width 64; inputs from numpy seeds. Each test states
its tolerance.
"""

import functools
import json
import math
import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.lr_schedulers import linear_warmup_cosine_annealing_lr as jax_schedule
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.trainer import LearningRateMonitor as JLearningRateMonitor
from mmlearn_tpu.trainer import Trainer as JTrainer
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.tasks import IJEPA, ContrastivePretraining
from mmlearn_tpu_torch.tasks.base import TrainingTask
from mmlearn_tpu_torch.trainer import (
    ConsoleLogger,
    JSONLLogger,
    LearningRateMonitor,
    ModelCheckpoint,
    Timer,
    Trainer,
)
from mmlearn_tpu_torch.trainer.trainer import _resolve_limit, validate_batch_shapes

VISION = dict(img_size=16, patch_size=8, embed_dim=64, depth=2, num_heads=4,
              use_cls_token=True, global_pool="cls", proj_dim=16)
TEXT = dict(vocab_size=32, max_length=8, embed_dim=64, depth=2, num_heads=4,
            causal=True, pooling="eos", proj_dim=16)
SCHEDULE = dict(base_lr=1e-3, warmup_steps=2)


def make_batches(n: int, batch: int = 4, seed: int = 0) -> list[dict]:
    """``n`` distinct image-text batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 30, (batch, 8)).astype(np.int32)
        ids[:, -1] = 31  # end of text: the row maximum
        out.append({"rgb": rng.standard_normal((batch, 16, 16, 3)).astype(np.float32),
                    "text": ids})
    return out


class Loader:
    """A sized loader over fixed batches; with ``shuffle`` the order is drawn
    from ``(seed, epoch)`` after ``set_epoch``."""

    def __init__(self, batches, shuffle: bool = False, seed: int = 7):
        self.batches, self.shuffle, self.seed, self.epoch = batches, shuffle, seed, 0
        self.epochs: list[int] = []

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.epochs.append(epoch)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        order = np.arange(len(self.batches))
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(order)
        return iter([dict(self.batches[i]) for i in order])


def port_task(**kw) -> ContrastivePretraining:
    """The tiny pair with the warmup-cosine AdamW, weights from a seed."""
    g = torch.Generator().manual_seed(0)
    return ContrastivePretraining(
        {"rgb": VisionTransformer(**VISION, generator=g),
         "text": TextTransformer(**TEXT, generator=g)},
        optimizer=functools.partial(torch.optim.AdamW, weight_decay=0.01),
        lr_scheduler=functools.partial(linear_warmup_cosine_annealing_lr, **SCHEDULE), **kw)


class Recorder:
    """Every hook's calls: the logged train metrics by step, validation steps
    and results, epoch ends."""

    def __init__(self):
        self.metrics, self.val_steps, self.val_results, self.epochs = {}, [], [], []

    def on_train_start(self, trainer): ...

    def on_train_batch_end(self, trainer, metrics, step):
        if metrics:
            self.metrics[step] = dict(metrics)

    def on_train_epoch_end(self, trainer, epoch):
        self.epochs.append(epoch)

    def on_validation_end(self, trainer, metrics, step):
        self.val_steps.append(step)
        self.val_results.append(dict(metrics))

    def on_train_end(self, trainer): ...

    def series(self, key):
        return np.array([self.metrics[s][key] for s in sorted(self.metrics)])


# ----------------------------------------------------- accumulation vs JAX


@pytest.mark.parametrize("algorithm,clip", [("norm", 0.5), ("value", 0.02)])
def test_accumulation_with_clipping_matches_jax_trainer(tmp_path, algorithm, clip):
    """k=2 over 8 micro-steps (4 optimizer steps) with clipping, from the
    same weights on the same batches, against the JAX ``Trainer`` (clipping
    inside ``optax.MultiSteps``). f32 on the CPU in two packages (sums in
    another order; MultiSteps' running mean, taken the same way): loss
    rtol 1e-5 at the first step and 3e-4 over all, the micro-batch gradient
    norm 1e-3, the LR monitor's rates 1e-6, final weights atol 2e-5 (the key
    bias: see below)."""
    batches = make_batches(4)
    jtask = JTask(encoders={"rgb": JVision(**VISION), "text": JText(**TEXT)},
                  optimizer=functools.partial(optax.adamw, weight_decay=0.01),
                  lr_scheduler=functools.partial(jax_schedule, **SCHEDULE))
    params = jax.device_get(jtask.init_params(jax.random.key(0), batches[0]))
    jtask.init_overlay = params
    jrec = Recorder()
    jtrainer = JTrainer(max_steps=8, accumulate_grad_batches=2, gradient_clip_val=clip,
                        gradient_clip_algorithm=algorithm, log_every_n_steps=1,
                        callbacks=[JLearningRateMonitor(), jrec], mesh_shape={"data": 1},
                        default_root_dir=str(tmp_path / "jax"), seed=0)
    jstate = jtrainer.fit(jtask, Loader(batches))

    task = port_task()
    task.load_state_dict(bridge.jax_to_torch(params), strict=True)
    rec = Recorder()
    trainer = Trainer(max_steps=8, accumulate_grad_batches=2, gradient_clip_val=clip,
                      gradient_clip_algorithm=algorithm, log_every_n_steps=1,
                      callbacks=[LearningRateMonitor(), rec],
                      default_root_dir=str(tmp_path / "port"), device="cpu")
    state = trainer.fit(task, Loader(batches))

    assert state.step == int(jstate.step) == 8
    assert state.lr_scheduler.last_epoch == 4  # the schedule steps once an update
    np.testing.assert_allclose(rec.series("loss")[0], jrec.series("loss")[0], rtol=1e-5)
    np.testing.assert_allclose(rec.series("loss"), jrec.series("loss"), rtol=3e-4)
    np.testing.assert_allclose(rec.series("grad_norm"), jrec.series("grad_norm"), rtol=1e-3)
    np.testing.assert_allclose(rec.series("lr"), jrec.series("lr"), rtol=1e-6)
    want = bridge.jax_to_torch(jax.device_get(jstate.params))
    # the key projection's bias has a zero gradient in exact arithmetic (a
    # softmax does not see a shift of a row's scores), so both packages
    # train it on rounding noise, which AdamW scales to steps of up to the
    # rate: held to twice the sum of the rates applied
    key_bias = np.zeros((4, 3, 16), bool)
    key_bias[:, 1] = True
    noise_bound = 2 * sum(trainer._lr_schedule(i) for i in range(4))
    for name, value in task.state_dict().items():
        got, ref = value.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            mask = key_bias.reshape(-1)
            np.testing.assert_array_less(np.abs(got - ref)[mask], noise_bound)
            got, ref = got[~mask], ref[~mask]
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=name)


class Quadratic(TrainingTask):
    """loss = mean((x w - y)^2), w from zeros; ``post_update`` records the
    step it is given."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.w = nn.Parameter(torch.zeros(4))
        self.updates: list[int] = []

    def loss_fn(self, batch):
        x, y = torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"])
        loss = ((x @ self.w - y) ** 2).mean()
        return loss, {"loss": loss.detach()}

    def post_update(self, step):
        self.updates.append(step)


def _quadratic_batches(n: int, micro: int):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n * micro, 4)).astype(np.float32)
    y = x @ np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    return [{"x": x[i * micro:(i + 1) * micro], "y": y[i * micro:(i + 1) * micro]}
            for i in range(n)]


def test_accumulation_matches_the_large_batch():
    """Two SGD updates either way, (k=2, 8 a micro-batch) and (k=1, 16):
    rtol 1e-5 (the mean of two means against one mean)."""
    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    small, large = Quadratic(optimizer=sgd), Quadratic(optimizer=sgd)
    Trainer(max_steps=4, accumulate_grad_batches=2, device="cpu").fit(
        small, _quadratic_batches(4, 8))
    Trainer(max_steps=2, device="cpu").fit(large, _quadratic_batches(2, 16))
    np.testing.assert_allclose(small.w.detach().numpy(), large.w.detach().numpy(), rtol=1e-5)


@pytest.mark.parametrize("k,updates", [(4, [0, 1]), (1, list(range(8)))])
def test_post_update_fires_once_per_optimizer_step(k, updates):
    """max_steps counts micro-steps; ``post_update`` (the EMA) gets the
    0-based optimizer step, once an update."""
    task = Quadratic(optimizer=functools.partial(torch.optim.SGD, lr=0.1))
    state = Trainer(max_steps=8, accumulate_grad_batches=k, log_every_n_steps=100,
                    device="cpu").fit(task, _quadratic_batches(8, 4))
    assert state.step == 8
    assert task.updates == updates


def test_ijepa_teacher_moves_once_per_optimizer_step():
    """The tiny I-JEPA task at k=2: the EMA teacher stays put over the first
    micro-step of a window and moves at its last, given the optimizer step."""
    enc = VisionTransformer(img_size=16, patch_size=4, embed_dim=64, depth=2, num_heads=4,
                            generator=torch.Generator().manual_seed(0))
    task = IJEPA(enc, generator=torch.Generator().manual_seed(1), ema_anneal_end_step=10)
    steps, teachers = [], []
    post_update = task.post_update

    def record(step):
        steps.append(step)
        post_update(step)

    task.post_update = record

    class Snapshot(Recorder):
        def on_train_batch_end(self, trainer, metrics, step):
            teachers.append([p.detach().clone() for p in task.teacher.parameters()])

    rng = np.random.default_rng(0)
    images = [{"rgb": rng.standard_normal((2, 16, 16, 3)).astype(np.float32)}
              for _ in range(4)]
    state = Trainer(max_steps=4, accumulate_grad_batches=2, callbacks=[Snapshot()],
                    device="cpu").fit(task, images)
    assert state.step == 4 and steps == [0, 1]
    moved = [any(not torch.equal(a, b) for a, b in zip(t0, t1))
             for t0, t1 in zip(teachers, teachers[1:])]
    assert moved == [True, False, True]  # after micro-steps 2, 3, 4


@pytest.mark.parametrize("k", [1, 2])
def test_the_last_applied_gradient_stays_in_grad(k):
    """After ``fit`` every trained parameter holds the gradient its last
    update applied (at k=2 the window's running mean), as the minimal
    trainer left it: ``chip_smoke.py`` reads the last step's gradients
    there. A rate of 0 keeps the weights where a fresh task has them."""
    batches = _quadratic_batches(4, 4)
    sgd = functools.partial(torch.optim.SGD, lr=0.0)
    task = Quadratic(optimizer=sgd)
    Trainer(max_steps=4, accumulate_grad_batches=k, device="cpu").fit(task, batches)
    ref = Quadratic(optimizer=sgd)
    grads = []
    for b in batches[4 - k:]:
        ref.w.grad = None
        ref.loss_fn(b)[0].backward()
        grads.append(ref.w.grad.clone())
    want = grads[0] if k == 1 else grads[0] + (grads[1] - grads[0]) / 2
    assert torch.equal(task.w.grad, want)


def test_lr_monitor_under_accumulation(tmp_path):
    """The monitor logs the rate of the latest update, schedule(step // k -
    1): mid-window steps repeat it (the JAX test's assertions)."""
    rec = Recorder()
    trainer = Trainer(max_steps=6, accumulate_grad_batches=2, log_every_n_steps=1,
                      callbacks=[LearningRateMonitor(), rec], default_root_dir=str(tmp_path),
                      device="cpu")
    trainer.fit(port_task(), Loader(make_batches(4)))
    sched = trainer._lr_schedule
    lrs = {s: m["lr"] for s, m in rec.metrics.items()}
    assert lrs == {s: sched(max(0, s // 2 - 1)) for s in range(1, 7)}
    assert lrs[2] == lrs[3] and lrs[4] == lrs[5]


# --------------------------------------------------------- validation loop


@pytest.mark.parametrize("interval,max_steps,want", [(3, 9, [3, 6, 9]), (0.5, 8, [2, 4, 6, 8])])
def test_val_check_interval(interval, max_steps, want):
    """An int is steps; a float a fraction of the (4-batch) epoch."""
    rec = Recorder()
    Trainer(max_steps=max_steps, val_check_interval=interval, limit_val_batches=1,
            callbacks=[rec], device="cpu").fit(port_task(), Loader(make_batches(4)),
                                               Loader(make_batches(4)))
    assert rec.val_steps == want
    with pytest.raises(ValueError, match=r"\(0\.0, 1\.0\]"):
        Trainer(val_check_interval=1.5)._resolve_val_interval(Loader(make_batches(4)))


@pytest.mark.parametrize("every,want", [(1, [2, 4, 6]), (2, [4])])
def test_epoch_end_validation_includes_the_final_epoch(every, want):
    """Validation at each ``check_val_every_n_epoch``-th epoch's end, the
    last epoch's included when the step budget ends on it."""
    rec = Recorder()
    Trainer(max_epochs=3, check_val_every_n_epoch=every, limit_val_batches=1,
            callbacks=[rec], device="cpu").fit(port_task(), Loader(make_batches(2)),
                                               Loader(make_batches(2)))
    assert rec.val_steps == want and rec.epochs == [0, 1, 2]


def test_validation_loss_is_the_mean_over_the_limited_batches():
    """``validation/loss`` is the mean of the task's loss in eval mode over
    ``limit_val_batches`` batches (exactly, the same function); 0 turns
    validation off; a task with ``compute_validation_loss=False`` logs none."""
    val = make_batches(3, seed=5)
    task = port_task()
    trainer = Trainer(max_steps=1, limit_val_batches=2, device="cpu")
    trainer.fit(task, Loader(make_batches(1)))
    got = trainer.validate(task, Loader(val))
    assert task.training  # the mode is restored
    with torch.no_grad():
        want = np.mean([float(task.eval().loss_fn(b)[0]) for b in val[:2]])
    assert got == {"validation/loss": want}
    assert Trainer(limit_test_batches=0, device="cpu").test(task, Loader(val)) == {}
    quiet = port_task(compute_validation_loss=False)
    assert Trainer(device="cpu").validate(quiet, Loader(val)) == {}


def test_limit_val_batches_zero_disables_validation():
    rec = Recorder()
    Trainer(max_steps=4, limit_val_batches=0, callbacks=[rec], device="cpu").fit(
        port_task(), Loader(make_batches(2)), Loader(make_batches(2)))
    assert rec.val_steps == []


def test_limit_train_batches_float_fraction():
    rec = Recorder()
    trainer = Trainer(max_epochs=2, limit_train_batches=0.5, log_every_n_steps=1,
                      callbacks=[rec], device="cpu")
    trainer.fit(port_task(), Loader(make_batches(4)))
    assert sorted(rec.metrics) == [1, 2, 3, 4] and trainer._limit_train == 2


def test_resolve_limit():
    sized = [0] * 4
    assert _resolve_limit(0.5, sized, "x") == 2
    assert _resolve_limit(1.0, sized, "x") is None
    assert _resolve_limit(0.0, sized, "x") == 0
    assert _resolve_limit(3, object(), "x") == 3
    assert _resolve_limit(None, object(), "x") is None
    with pytest.raises(ValueError, match=r"\[0\.0, 1\.0\]"):
        _resolve_limit(1.5, sized, "limit_train_batches")
    with pytest.raises(ValueError, match="sized dataloader"):
        _resolve_limit(0.5, iter(sized), "limit_train_batches")
    with pytest.raises(ValueError, match="resolves to 0"):
        _resolve_limit(0.1, sized, "limit_train_batches")


def test_sanity_validation_is_not_logged():
    rec = Recorder()
    Trainer(max_steps=1, num_sanity_val_steps=1, callbacks=[rec], device="cpu").fit(
        port_task(), Loader(make_batches(1)))
    assert rec.val_steps == []  # no val loader in fit: none; with one, unlogged
    Trainer(max_steps=2, num_sanity_val_steps=1, val_check_interval=2, callbacks=[rec],
            device="cpu").fit(port_task(), Loader(make_batches(2)), Loader(make_batches(1)))
    assert rec.val_steps == [2]


# ---------------------------------------------------- stopping and options


def test_fast_dev_run_drops_checkpoints(tmp_path):
    rec = Recorder()
    state = Trainer(fast_dev_run=True, log_every_n_steps=1,
                    callbacks=[ModelCheckpoint(dirpath=str(tmp_path)), rec],
                    default_root_dir=str(tmp_path), device="cpu").fit(
        port_task(), Loader(make_batches(2)), Loader(make_batches(2)))
    assert state.step == 1 and sorted(rec.metrics) == [1] and rec.val_steps == [1]
    assert not any(name.isdigit() for name in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="gradient_clip_algorithm"):
        Trainer(gradient_clip_algorithm="nope")


def test_should_stop_ends_training_after_the_step():
    class StopAt(Recorder):
        def on_train_batch_end(self, trainer, metrics, step):
            super().on_train_batch_end(trainer, metrics, step)
            if step == 2:
                trainer.should_stop = True

    rec = StopAt()
    trainer = Trainer(max_steps=10, log_every_n_steps=1, callbacks=[rec], device="cpu")
    state = trainer.fit(port_task(), Loader(make_batches(4)))
    assert state.step == 2 and len(trainer.history) == 2


def test_sigterm_stops_cleanly_and_the_resume_is_bit_equal(tmp_path):
    """SIGTERM at step 3 of 6: the run stops after that step, writes its end
    checkpoint and restores the previous handler; the resumed run's records
    and weights equal the uninterrupted run's bit for bit."""

    class KillAt(Recorder):
        def on_train_batch_end(self, trainer, metrics, step):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    def run(callbacks, ckpt_path=None):
        trainer = Trainer(max_steps=6, accumulate_grad_batches=2, log_every_n_steps=2,
                          gradient_clip_val=0.5, callbacks=callbacks,
                          default_root_dir=str(tmp_path), device="cpu")
        task = port_task()
        state = trainer.fit(task, Loader(make_batches(4)), ckpt_path=ckpt_path)
        return trainer.history, task.state_dict(), state

    full, weights, _ = run([])
    ck = str(tmp_path / "ckpt")
    before = signal.getsignal(signal.SIGTERM)
    first, _, stopped = run([ModelCheckpoint(dirpath=ck, async_save=False), KillAt()])
    assert stopped.step == 3 and stopped.accumulated is not None  # mid-window
    assert signal.getsignal(signal.SIGTERM) == before
    rest, resumed, _ = run([ModelCheckpoint(dirpath=ck, async_save=False)], ckpt_path="last")
    assert first + rest == full
    for name, value in weights.items():
        assert torch.equal(resumed[name], value), name


def test_detect_anomaly_raises_on_a_nan_gradient():
    class NanGrad(Quadratic):
        def loss_fn(self, batch):
            loss = (self.w * float("nan")).sum()
            return loss, {"loss": loss.detach()}

    with pytest.raises(RuntimeError, match="nan"):
        Trainer(max_steps=1, detect_anomaly=True, device="cpu").fit(
            NanGrad(), _quadratic_batches(1, 4))
    Trainer(max_steps=1, device="cpu").fit(NanGrad(), _quadratic_batches(1, 4))


def test_validate_batch_shapes_errors():
    good = {"rgb": np.zeros((4, 2, 2)), "text": torch.zeros(4, 3)}
    assert validate_batch_shapes(good) == 4
    with pytest.raises(ValueError, match="inconsistent batch dims"):
        validate_batch_shapes({"rgb": np.zeros((4, 2)), "text": np.zeros((3, 2))})
    with pytest.raises(ValueError, match="object dtype"):
        validate_batch_shapes({"rgb": np.asarray([object()], dtype=object)})
    with pytest.raises(ValueError, match="is empty"):
        validate_batch_shapes({"rgb": np.zeros((0, 2))})
    assert validate_batch_shapes({"rgb": np.zeros((4, 2)),
                                  "ijepa_encoder_masks": np.zeros((1, 4, 5))}) == 4
    with pytest.raises(ValueError, match="inconsistent"):  # checked in fit, first batch
        Trainer(max_steps=1, device="cpu").fit(
            port_task(), [{"rgb": np.zeros((4, 16, 16, 3), np.float32),
                           "text": np.ones((3, 8), np.int32)}])


def test_one_pass_iterator_runs_out():
    with pytest.raises(ValueError, match="one-pass iterator"):
        Trainer(max_steps=3, device="cpu").fit(port_task(), iter(make_batches(2)))


def test_evaluation_tasks_are_not_ported():
    """What of the JAX task's evaluation options the port still refuses.
    Evaluation tasks themselves are ported (``tests/test_torch_eval_tasks.py``)
    and kept as ``EvaluationSpec``s; auxiliary tasks are ported too
    (``tests/test_torch_multitask.py``): a spec of another type is refused.
    (The name is older than both ports.)"""
    from mmlearn_tpu_torch.tasks import EvaluationSpec

    task = port_task(evaluation_tasks={"retrieval": {"task": object()}})
    assert isinstance(task.evaluation_tasks["retrieval"], EvaluationSpec)
    with pytest.raises(TypeError, match="AuxiliaryTaskSpec"):
        port_task(auxiliary_tasks={"retrieval": object()})


# ------------------------------------------------- loggers, timer, metrics


def test_loggers_timer_and_mfu_metrics(tmp_path, monkeypatch, caplog):
    """JSONL lines a logged step (train and validation), the timer's rate,
    and with ``log_mfu`` the counted FLOPs a step, TFLOP/s and MFU against
    ``MMLEARN_PEAK_TFLOPS`` (the CPU has no peak in the table)."""
    monkeypatch.setenv("MMLEARN_PEAK_TFLOPS", "0.5")
    rec = Recorder()
    trainer = Trainer(max_steps=4, log_every_n_steps=2, val_check_interval=4,
                      limit_val_batches=1, log_mfu=True,
                      callbacks=[Timer(), rec], loggers=[JSONLLogger(str(tmp_path)),
                                                         ConsoleLogger()], device="cpu")
    with caplog.at_level("INFO", "mmlearn_tpu_torch.trainer.loggers"):
        trainer.fit(port_task(), Loader(make_batches(2)), Loader(make_batches(1)))
    assert trainer._step_flops > 0
    assert sorted(rec.metrics) == [2, 4]
    for m in rec.metrics.values():
        assert m["steps_per_sec"] > 0 and m["tflops_per_sec"] > 0
        assert m["mfu"] == pytest.approx(m["tflops_per_sec"] / 0.5)
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [2, 4, 4]
    assert math.isfinite(lines[0]["train/loss"]) and "validation/loss" in lines[2]
    assert any("train/loss=" in r.message for r in caplog.records)
