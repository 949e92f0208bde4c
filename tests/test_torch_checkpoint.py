"""Checkpoints and resume of the port's trainer on the CPU: the counterparts
of ``tests/tasks/test_checkpoint_resume.py`` and ``test_averaging.py``,
and a JAX train state carried into the port by ``bridge.train_state_from_jax``
going on as the JAX run goes on.

A resumed run on the CPU equals the uninterrupted one bit for bit: the same
operations on the same values in one process.
"""

import functools
import json
import math
import os

import jax
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.lr_schedulers import linear_warmup_cosine_annealing_lr as jax_schedule
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.tasks.base import decay_mask as jax_decay_mask
from mmlearn_tpu.trainer import Trainer as JTrainer
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from mmlearn_tpu_torch.trainer import ModelCheckpoint, Trainer, TrainState, average_checkpoints
from mmlearn_tpu_torch.trainer.callbacks import STATE_FILE, write_state
from tests.test_torch_trainer_fit import (
    SCHEDULE,
    TEXT,
    VISION,
    Loader,
    Recorder,
    make_batches,
    port_task,
)


def run(tmp_path, max_steps, ckpt=None, resume=None, loader=None, callbacks=(), **kw):
    """A fit of the tiny pair: its history, weights and trainer."""
    task = port_task()
    trainer = Trainer(max_steps=max_steps, log_every_n_steps=1,
                      callbacks=[*callbacks, *([] if ckpt is None else [ckpt])],
                      default_root_dir=str(tmp_path), device="cpu", **kw)
    trainer.fit(task, loader or Loader(make_batches(3)), ckpt_path=resume)
    return trainer.history, task.state_dict(), trainer


def assert_equal_weights(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("k,every", [(1, 3), (2, 3)], ids=["k1", "k2_mid_window"])
def test_resume_equals_the_uninterrupted_run(tmp_path, k, every):
    """6 straight steps equal 3 steps, a checkpoint and 3 resumed steps, bit
    for bit; at k=2 the checkpoint falls mid-window and carries the
    accumulated gradient."""
    full, weights, _ = run(tmp_path, 6, accumulate_grad_batches=k, gradient_clip_val=0.5)
    ck = str(tmp_path / "ck")
    first, _, t1 = run(tmp_path, 3, ModelCheckpoint(ck, every_n_train_steps=every,
                                                    every_n_epochs=None),
                       accumulate_grad_batches=k, gradient_clip_val=0.5)
    saved = torch.load(os.path.join(ck, "3", STATE_FILE), weights_only=True)
    assert saved["step"] == 3 and bool(saved["accumulated"]) == (k == 2)
    rest, resumed, t2 = run(tmp_path, 6, ModelCheckpoint(ck, every_n_epochs=None), resume="last",
                            accumulate_grad_batches=k, gradient_clip_val=0.5)
    assert t2.restored_step == 3
    assert first + rest == full
    assert_equal_weights(resumed, weights)


def test_resume_from_an_explicit_directory_and_a_missing_one(tmp_path):
    ck = str(tmp_path / "ck")
    run(tmp_path, 2, ModelCheckpoint(ck))
    hist, _, trainer = run(tmp_path, 3, resume=ck)
    assert trainer.restored_step == 2 and [h["step"] for h in hist] == [2]
    with pytest.raises(FileNotFoundError):
        run(tmp_path, 1, resume=str(tmp_path / "nope"))
    hist, _, _ = run(tmp_path / "fresh", 1, resume="last")  # nothing there: from scratch
    assert [h["step"] for h in hist] == [0]


def test_completed_run_resumed_trains_no_extra_steps(tmp_path):
    ck = str(tmp_path / "ck")
    _, weights, _ = run(tmp_path, 3, ModelCheckpoint(ck))
    mtime = os.path.getmtime(os.path.join(ck, "3", STATE_FILE))
    hist, again, trainer = run(tmp_path, 3, ModelCheckpoint(ck), resume="last")
    assert hist == [] and trainer.state.step == 3
    assert_equal_weights(again, weights)
    assert os.path.getmtime(os.path.join(ck, "3", STATE_FILE)) == mtime  # not rewritten


def test_epoch_position_resume_with_a_shuffled_loader(tmp_path):
    """2 steps, then a resume to 5 over a loader shuffled by epoch (3
    batches an epoch): the resumed run sets epoch 0, skips the 2 batches the
    checkpoint consumed, then epoch 1, and ends on the uninterrupted run's
    weights bit for bit."""
    batches = make_batches(3)
    _, straight, _ = run(tmp_path, 5, loader=Loader(batches, shuffle=True))
    ck = str(tmp_path / "ck")
    run(tmp_path, 2, ModelCheckpoint(ck), loader=Loader(batches, shuffle=True))
    loader = Loader(batches, shuffle=True)
    _, resumed, _ = run(tmp_path, 5, ModelCheckpoint(ck), resume="last", loader=loader)
    assert loader.epochs == [0, 1]
    assert_equal_weights(resumed, straight)


class Stream:
    """An unsized loader: 4 batches an epoch in an order drawn from the
    epoch."""

    def __init__(self, batches):
        self.batches, self.epoch = batches, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        order = np.random.default_rng((3, self.epoch)).permutation(len(self.batches))
        return iter([dict(self.batches[i]) for i in order])


def test_unsized_loader_resumes_mid_epoch_from_the_saved_position(tmp_path):
    """Stopped at step 6 (epoch 1, batch 2) and resumed to 8: the loop
    position saved beside the checkpoint puts the stream where it was."""
    batches = make_batches(4)
    full, straight, _ = run(tmp_path, 8, loader=Stream(batches))
    ck = str(tmp_path / "ck")

    class StopAt6(Recorder):  # stopped, not a shorter run: the same schedule
        def on_train_batch_end(self, trainer, metrics, step):
            trainer.should_stop = step == 6

    run(tmp_path, 8, ModelCheckpoint(ck), loader=Stream(batches), callbacks=[StopAt6()])
    with open(os.path.join(ck, "loop_position-6.json")) as f:
        assert json.load(f) == {"step": 6, "epoch": 1, "batch_in_epoch": 2}
    rest, resumed, _ = run(tmp_path, 8, ModelCheckpoint(ck), resume="last",
                           loader=Stream(batches))
    assert rest == full[6:]
    assert_equal_weights(resumed, straight)


def test_non_strict_restore_across_a_config_change(tmp_path):
    """A checkpoint of 2-block towers into a 3-block image tower: the
    matching weights and moments are taken, the new block stays fresh."""
    ck = str(tmp_path / "ck")
    _, saved, _ = run(tmp_path, 2, ModelCheckpoint(ck))
    g = torch.Generator().manual_seed(1)
    task = ContrastivePretraining(
        {"rgb": VisionTransformer(**{**VISION, "depth": 3}, generator=g),
         "text": TextTransformer(**TEXT, generator=g)},
        optimizer=functools.partial(torch.optim.AdamW, weight_decay=0.01),
        lr_scheduler=functools.partial(linear_warmup_cosine_annealing_lr, **SCHEDULE))
    fresh = {k: v.clone() for k, v in task.state_dict().items()}
    with pytest.raises(RuntimeError):
        Trainer(max_steps=2, device="cpu").fit(task, Loader(make_batches(1)), ckpt_path=ck)
    trainer = Trainer(max_steps=2, device="cpu")
    trainer.fit(task, Loader(make_batches(1)), ckpt_path=ck, strict_loading=False)
    now = task.state_dict()
    for name in saved:
        assert torch.equal(now[name], saved[name]), name
    new = [n for n in now if n.startswith("encoders.rgb.blocks.2.")]
    assert new and all(torch.equal(now[n], fresh[n]) for n in new)
    assert trainer.state.step == 2


def _monitored(tmp_path, **kw):
    return ModelCheckpoint(dirpath=str(tmp_path / "ck"), monitor="validation/loss", mode="min",
                           save_top_k=1, every_n_epochs=None, save_last=False,
                           async_save=False, **kw)


def _kept(tmp_path):
    return {d for d in os.listdir(tmp_path / "ck") if d.isdigit()}


def test_monitor_top_k_pins_the_best(tmp_path):
    ckpt = _monitored(tmp_path)
    _, _, trainer = run(tmp_path, 3, ckpt)
    ckpt.on_validation_end(trainer, {"validation/loss": 5.0}, 1)
    ckpt.on_validation_end(trainer, {"validation/loss": 1.5}, 2)
    ckpt.on_validation_end(trainer, {"validation/loss": 4.0}, 3)  # no write
    ckpt.on_train_end(trainer)
    assert ckpt.best_model_path.endswith(os.sep + "2") and _kept(tmp_path) == {"2"}
    assert ckpt._best_scores == [1.5]
    assert ckpt.restore_best(trainer) == 2 and trainer.state.step == 3
    ckpt.on_validation_end(trainer, {"other": 1.0}, 4)  # a warning, not an error


def test_monitor_nan_guard_and_rehydration(tmp_path):
    ckpt = _monitored(tmp_path)
    _, _, trainer = run(tmp_path, 2, ckpt)
    ckpt.on_validation_end(trainer, {"validation/loss": math.nan}, 1)
    assert ckpt._best_scores == []
    ckpt.on_validation_end(trainer, {"validation/loss": 2.0}, 2)
    ckpt.on_train_end(trainer)
    again = _monitored(tmp_path)  # a resumed run's fresh callback reads the pins
    again.on_validation_end(trainer, {"validation/loss": 3.5}, 3)
    assert again._best_scores == [2.0] and again.best_model_path.endswith(os.sep + "2")
    again.on_validation_end(trainer, {"validation/loss": 1.0}, 4)
    again.on_train_end(trainer)
    assert again._best_scores == [1.0] and again.best_model_path.endswith(os.sep + "4")


def test_monitored_then_periodic_save_of_one_step_writes_once(tmp_path, caplog):
    ckpt = _monitored(tmp_path)
    _, _, trainer = run(tmp_path, 2, ckpt)
    with caplog.at_level("WARNING", "mmlearn_tpu_torch.trainer.callbacks"):
        ckpt.on_validation_end(trainer, {"validation/loss": 1.0}, 2)
        ckpt._save(trainer, 2)
        ckpt.on_train_end(trainer)
    assert not any("stale" in r.message for r in caplog.records)
    assert ckpt._monitored == {2: 1.0} and 2 in ckpt._periodic_steps
    assert _kept(tmp_path) == {"2"}
    assert os.path.exists(tmp_path / "ck" / "loop_position-2.json")


def test_eviction_spares_the_resumed_checkpoint(tmp_path):
    ckpt = _monitored(tmp_path, every_n_train_steps=1, max_to_keep=3)
    _, _, trainer = run(tmp_path, 3, ckpt)  # periodic saves at 1, 2, 3
    ckpt.on_validation_end(trainer, {"validation/loss": 2.0}, 3)
    ckpt.on_train_end(trainer)
    again = _monitored(tmp_path, every_n_train_steps=1, max_to_keep=3)
    trainer.restored_step = 3
    again._save(trainer, 4)
    again.on_validation_end(trainer, {"validation/loss": 1.0}, 4)
    again.on_train_end(trainer)
    assert "3" in _kept(tmp_path) and again._monitored == {4: 1.0}


def test_max_to_keep_and_async_saves(tmp_path):
    """Every step saved from a thread; the newest 2 stay, and the last
    equals the run's state."""
    ckpt = ModelCheckpoint(str(tmp_path / "ck"), every_n_train_steps=1, max_to_keep=2)
    _, weights, _ = run(tmp_path, 5, ckpt)
    assert _kept(tmp_path) == {"4", "5"}
    saved = torch.load(tmp_path / "ck" / "5" / STATE_FILE, weights_only=True)
    assert_equal_weights(saved["task"], weights)


def test_corrupt_pin_file_is_tolerated(tmp_path):
    cb = ModelCheckpoint(dirpath=str(tmp_path))
    for payload in ("[1, 2]", '{"a": 1.0}', '{"3": "oops"}', "null", "{bad"):
        (tmp_path / "monitored_scores.json").write_text(payload)
        cb._monitored = {}
        cb._rehydrate_monitored(str(tmp_path))
        assert cb._monitored == {}
    (tmp_path / "monitored_scores.json").write_text('{"3": 1.5, "7": 0.25}')
    cb._rehydrate_monitored(str(tmp_path))
    assert cb._monitored == {3: 1.5, 7: 0.25}


def test_a_half_written_step_is_never_resumed(tmp_path):
    """A directory under a temporary name (a write cut off) and a step
    directory without its state are not checkpoints: the resume takes the
    newest complete one, and the leftovers are cleaned."""
    ck = tmp_path / "ck"
    run(tmp_path, 2, ModelCheckpoint(str(ck)))
    os.makedirs(ck / "5.tmp-123-456")
    (ck / "5.tmp-123-456" / STATE_FILE).write_bytes(b"half")
    os.makedirs(ck / "7")
    hist, _, trainer = run(tmp_path, 3, ModelCheckpoint(str(ck)), resume="last")
    assert trainer.restored_step == 2 and [h["step"] for h in hist] == [2]
    assert not (ck / "5.tmp-123-456").exists()


def test_average_checkpoints(tmp_path):
    """Float trained weights averaged (in f64, back to their type); the
    rest, and the teacher-like extras unless asked, from the last step."""
    ck = tmp_path / "ck"
    task = torch.nn.Module()
    states = []
    for step, (w, e) in enumerate([([1.0, 3.0], 0.0), ([3.0, 5.0], 2.0)], start=1):
        state = {"step": step,
                 "task": {"w": torch.tensor(w), "ids": torch.tensor([6 + step]),
                          "teacher": torch.tensor([e])},
                 "optimizer": {"state": {"w": {}}, "param_groups": [{"params": ["w"]}]},
                 "lr_scheduler": None, "accumulated": {}}
        write_state(str(ck), 2 * step - 1, state)
        states.append(state)
    del task
    soup = average_checkpoints(str(ck))
    assert soup["task"]["w"].tolist() == [2.0, 4.0] and soup["task"]["w"].dtype == torch.float32
    assert soup["task"]["ids"].tolist() == [8] and soup["step"] == 2
    assert soup["task"]["teacher"].tolist() == [2.0]
    assert average_checkpoints(str(ck), average_extras=True)["task"]["teacher"].tolist() == [1.0]
    assert average_checkpoints(str(ck), steps=[1])["task"]["w"].tolist() == [1.0, 3.0]
    with pytest.raises(ValueError, match="not in"):
        average_checkpoints(str(ck), steps=[2])
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="No checkpoints"):
        average_checkpoints(str(tmp_path / "empty"))


def test_averaged_checkpoint_loads_into_the_state(tmp_path):
    ck = str(tmp_path / "ck")
    _, _, trainer = run(tmp_path, 4, ModelCheckpoint(ck, every_n_train_steps=2,
                                                     every_n_epochs=None))
    soup = average_checkpoints(ck)
    trainer.state.load_state_dict(soup)
    a = torch.load(os.path.join(ck, "2", STATE_FILE), weights_only=True)["task"]
    b = torch.load(os.path.join(ck, "4", STATE_FILE), weights_only=True)["task"]
    w = "encoders.rgb.blocks.0.attn.qkv.weight"
    torch.testing.assert_close(trainer.state.task.state_dict()[w], (a[w] + b[w]) / 2,
                               rtol=0, atol=1e-7)


def test_jax_train_state_goes_on_in_the_port(tmp_path):
    """3 micro-steps of the JAX ``Trainer`` at k=2 (a window left open),
    carried by ``bridge.train_state_from_jax`` into a port checkpoint, then
    3 more in the port: its losses and final weights against the JAX run's
    own steps 3-5 (f32, two packages: loss rtol 1e-5, weights atol 2e-5, the
    key bias within twice the rates applied, as in
    ``test_torch_trainer_fit``). The AdamW moments land on the port's two
    decay groups."""
    batches = make_batches(3)
    jtask = JTask(encoders={"rgb": JVision(**VISION), "text": JText(**TEXT)},
                  optimizer=functools.partial(optax.adamw, weight_decay=0.01),
                  lr_scheduler=functools.partial(jax_schedule, **SCHEDULE))
    params = jax.device_get(jtask.init_params(jax.random.key(0), batches[0]))
    jtask.init_overlay = params
    at_3 = {}

    class Grab(Recorder):
        def on_train_batch_end(self, trainer, metrics, step):
            super().on_train_batch_end(trainer, metrics, step)
            if step == 3:
                at_3["state"] = jax.device_get(trainer.state)

    jrec = Grab()
    jstate = JTrainer(max_steps=6, accumulate_grad_batches=2, log_every_n_steps=1,
                      callbacks=[jrec], mesh_shape={"data": 1},
                      default_root_dir=str(tmp_path / "jax"), seed=0).fit(jtask, Loader(batches))

    ck = str(tmp_path / "ck")
    carried = bridge.train_state_from_jax(at_3["state"])
    assert carried["step"] == 3 and carried["accumulated"]
    write_state(ck, 3, carried)
    task = port_task()
    opt, _ = task.configure_optimizers(max_steps=6)
    decayed = {n for n, p in task.named_parameters()
               if any(p is q for q in opt.param_groups[0]["params"])}
    want_decay = bridge.jax_to_torch(jax.tree.map(lambda p, m: np.full(np.shape(p), bool(m)),
                                                  params, jax_decay_mask(params)))
    assert decayed == {n for n, v in want_decay.items() if bool(v.all())}
    trainer = Trainer(max_steps=6, accumulate_grad_batches=2, log_every_n_steps=1,
                      device="cpu")
    state = trainer.fit(task, Loader(batches), ckpt_path=ck)
    assert isinstance(state, TrainState) and state.lr_scheduler.last_epoch == 3
    np.testing.assert_allclose([h["loss"] for h in trainer.history],
                               jrec.series("loss")[3:], rtol=1e-5)
    want = bridge.jax_to_torch(jax.device_get(jstate.params))
    key_bias = np.zeros((4, 3, 16), bool)
    key_bias[:, 1] = True
    key_bias = key_bias.reshape(-1)
    bound = 2 * sum(trainer._lr_schedule(i) for i in range(3))
    for name, value in task.state_dict().items():
        got, ref = value.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            np.testing.assert_array_less(np.abs(got - ref)[key_bias], bound)
            got, ref = got[~key_bias], ref[~key_bias]
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=name)
