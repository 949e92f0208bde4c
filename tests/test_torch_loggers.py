"""The port's W&B and TensorBoard loggers (``mmlearn_tpu_torch.trainer.loggers``)
on the CPU, beside the JAX package's on the same calls: TensorBoard's event
files of both read back with ``tensorboard``'s ``EventAccumulator``
(``version_<n>``, tags, scalars, steps), both W&B loggers against one stub
``wandb`` module (the ``init`` arguments, ``log``, the config and
``finish``), both no-ops where their package is missing, both in the
``trainer/logger`` group as the JAX package registers them, and both fed by
``Trainer.fit``."""

import os
import sys
import types

import pytest
import torch

from mmlearn_tpu_torch.trainer.loggers import TensorBoardLogger, WandbLogger


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _events(log_dir):
    """Every tag of the event files under ``log_dir`` (scalars and the
    hyperparameter summaries), each scalar's steps and values."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    tags = {kind: sorted(v) if isinstance(v, list) else v for kind, v in acc.Tags().items()}
    try:
        hparams = acc.PluginTagToContent("hparams")
    except KeyError:  # no hyperparameters logged in this run
        hparams = {}
    return tags, _scalars(log_dir), hparams


def _tensorboard_run(cls, save_dir):
    """The same calls through either package's logger: two runs under one
    ``save_dir``/``name``, then a third at a given version."""
    first = cls(save_dir=save_dir, name="runs")
    first.log_hyperparams({"lr": 0.1, "model": {"depth": 2}})
    first.log_metrics({"train/loss": 1.5, "note": "warm-up"}, step=1)
    first.log_metrics({"train/loss": torch.tensor(0.75), "train/lr": 0.5}, step=4)
    first.finalize()
    second = cls(save_dir=save_dir, name="runs")
    second.log_metrics({"val/recall": 0.25}, step=7)
    second.finalize()
    third = cls(save_dir=save_dir, name="runs", version=9)
    third.finalize()
    return first, second, third


def test_tensorboard_writes_scalars_into_the_next_version(tmp_path):
    """The same calls through the port's and the JAX package's
    ``TensorBoardLogger``: the same ``version_<n>`` directories (two
    loggers under one ``save_dir``/``name`` take ``version_0`` and
    ``version_1``, a given ``version`` is used as it is), and in each the
    same tags, scalars at their steps (f32 event values) and hyperparameter
    summaries; a metric that is not a number is skipped."""
    from mmlearn_tpu.trainer.loggers import TensorBoardLogger as JTensorBoardLogger

    port = _tensorboard_run(TensorBoardLogger, str(tmp_path / "port"))
    want = _tensorboard_run(JTensorBoardLogger, str(tmp_path / "jax"))
    versions = sorted(os.listdir(tmp_path / "port" / "runs"))
    assert versions == sorted(os.listdir(tmp_path / "jax" / "runs")) == [
        "version_0", "version_1", "version_9"]
    for got, ref in zip(port, want):
        assert os.path.relpath(got.log_dir, tmp_path / "port") == os.path.relpath(
            ref.log_dir, tmp_path / "jax")
        assert _events(got.log_dir) == _events(ref.log_dir)
    got = _scalars(port[0].log_dir)
    assert got["train/loss"] == [(1, 1.5), (4, 0.75)]
    assert got["train/lr"] == [(4, 0.5)]
    assert "note" not in got
    assert _scalars(port[1].log_dir) == {"val/recall": [(7, 0.25)]}
    assert _events(port[0].log_dir)[2]  # the hyperparameters were written


class _Run:
    def __init__(self, calls):
        self.calls = calls
        self.config = types.SimpleNamespace(
            update=lambda params, allow_val_change: calls.append(("config", params,
                                                                  allow_val_change)))

    def log(self, metrics, step):
        self.calls.append(("log", metrics, step))

    def finish(self):
        self.calls.append(("finish",))


@pytest.fixture()
def wandb_stub(monkeypatch):
    calls = []
    module = types.ModuleType("wandb")
    module.init = lambda **kwargs: calls.append(("init", kwargs)) or _Run(calls)
    monkeypatch.setitem(sys.modules, "wandb", module)
    monkeypatch.setenv("WANDB_PROJECT", "med-bench")
    return calls


def _wandb_run(cls, save_dir):
    """The same calls through either package's logger: a run with its
    name, directory, tags and id, and one with only a project."""
    lg = cls(name="baseline", save_dir=save_dir, tags=["med"], id="run-1")
    lg.log_hyperparams({"seed": 0})
    lg.log_metrics({"train/loss": 2.0}, step=3)
    lg.finalize()
    cls(project="other")
    return lg


def test_wandb_logs_through_one_run(wandb_stub, tmp_path):
    """The same calls through the port's and the JAX package's
    ``WandbLogger`` against one stub ``wandb``: the same calls to ``init``
    (project from ``$WANDB_PROJECT`` unless given, ``resume="allow"``),
    ``log`` with the step, the hyperparameters into the run's config and
    ``finish``. The port's ``finalize`` then finishes no more."""
    from mmlearn_tpu.trainer.loggers import WandbLogger as JWandbLogger

    _wandb_run(JWandbLogger, str(tmp_path))
    want = list(wandb_stub)
    wandb_stub.clear()
    lg = _wandb_run(WandbLogger, str(tmp_path))
    assert wandb_stub == want
    assert wandb_stub[:4] == [
        ("init", dict(name="baseline", project="med-bench", dir=str(tmp_path), tags=["med"],
                      resume="allow", id="run-1")),
        ("config", {"seed": 0}, True),
        ("log", {"train/loss": 2.0}, 3),
        ("finish",),
    ]
    assert wandb_stub[-1][1]["project"] == "other"
    lg.finalize()
    assert len(wandb_stub) == len(want)


@pytest.mark.parametrize("package", ["wandb", "torch.utils.tensorboard"])
def test_loggers_are_no_ops_without_their_package(package, monkeypatch, tmp_path, caplog):
    """Where the package is missing the logger warns once and every call is
    a no-op (nothing written)."""
    monkeypatch.setitem(sys.modules, package, None)
    with caplog.at_level("WARNING"):
        lg = (WandbLogger(save_dir=str(tmp_path)) if package == "wandb"
              else TensorBoardLogger(save_dir=str(tmp_path)))
    assert "no-op" in caplog.text
    lg.log_hyperparams({"a": 1})
    lg.log_metrics({"loss": 1.0}, step=1)
    lg.finalize()
    assert list(tmp_path.iterdir()) == []


def test_loggers_registered_as_in_the_jax_store(tmp_path):
    """``WandbLogger`` and ``TensorBoardLogger`` in the ``trainer/logger``
    group, as the JAX package registers them, and instantiable from there."""
    from mmlearn_tpu.conf import store as jax_store
    from mmlearn_tpu.trainer import loggers as jax_loggers  # noqa: F401

    from mmlearn_tpu_torch.conf import instantiate, store

    for name in ("WandbLogger", "TensorBoardLogger"):
        assert jax_store.has("trainer/logger", name) and store.has("trainer/logger", name)
        node = store.get("trainer/logger", name)
        assert node["_target_"] == f"mmlearn_tpu_torch.trainer.loggers.{name}"
    assert isinstance(instantiate(store.get("trainer/logger", "TensorBoardLogger"),
                                  save_dir=str(tmp_path), version=0),
                      TensorBoardLogger)


def test_fit_feeds_tensorboard(tmp_path):
    """``Trainer.fit`` of a tiny task with the TensorBoard logger: the
    logged train metrics at their steps, the event file read back."""
    from mmlearn_tpu_torch.tasks.base import TrainingTask
    from mmlearn_tpu_torch.trainer import Trainer

    class Line(TrainingTask):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(2.0))

        def loss_fn(self, batch):
            loss = (self.w * torch.as_tensor(batch["x"]).float()).pow(2).mean()
            return loss, {"loss": loss}

    lg = TensorBoardLogger(save_dir=str(tmp_path))
    batches = [{"x": torch.ones(2) * i} for i in range(1, 5)]
    Trainer(max_steps=4, log_every_n_steps=2, loggers=[lg], device="cpu").fit(Line(), batches)
    got = _scalars(lg.log_dir)
    assert [s for s, _ in got["train/loss"]] == [2, 4]
