"""The PyTorch port against the fixtures recorded from the original torch
mmlearn: the contrastive loss, the warmup-cosine schedule and the 50-step
contrastive training trajectory (``scripts/record_reference_fixtures.py``),
at the tolerances of the JAX package's own tests of the same fixtures
(``tests/modules/test_reference_parity.py:31-68`` and
``tests/tasks/test_training_trajectory.py:452-522``).
"""

import functools
import os

import numpy as np
import pytest
import torch
from torch import nn

from mmlearn_tpu_torch.modules.encoders.base import EncoderOutput
from mmlearn_tpu_torch.modules.losses import ContrastiveLoss, LossPairSpec
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from mmlearn_tpu_torch.trainer import LearningRateMonitor, Trainer
from tests.tasks.test_training_trajectory import TRAJ, make_trajectory_data

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("case,kwargs", [("plain", {}), ("l2norm", {"l2_normalize": True}),
                                         ("alignment", {"modality_alignment": True})])
def test_contrastive_loss_matches_reference(case, kwargs):
    ref = np.load(os.path.join(FIXTURES, "reference_contrastive_loss.npz"))
    emb = {"rgb": torch.from_numpy(ref["za"]), "text": torch.from_numpy(ref["zb"])}
    ids = {"rgb": torch.from_numpy(ref["ids"]), "text": torch.from_numpy(ref["ids"])}
    loss, _ = ContrastiveLoss(**kwargs)(emb, ids, torch.tensor(float(ref["scale"])),
                                        [LossPairSpec(("rgb", "text"))])
    np.testing.assert_allclose(float(loss), float(ref[f"loss_{case}"]), rtol=1e-5)


def test_lr_schedule_matches_reference():
    ref = np.load(os.path.join(FIXTURES, "reference_lr_schedule.npz"))
    sched = linear_warmup_cosine_annealing_lr(
        base_lr=float(ref["base_lr"]), warmup_steps=int(ref["warmup_steps"]),
        max_steps=int(ref["max_steps"]), start_factor=float(ref["start_factor"]),
        eta_min=float(ref["eta_min"]))
    ours = np.asarray([sched(s) for s in range(len(ref["lrs"]))])
    np.testing.assert_allclose(ours, ref["lrs"], atol=2e-2)
    np.testing.assert_allclose(ours[0], ref["lrs"][0], rtol=1e-6)
    np.testing.assert_allclose(ours[10], ref["lrs"][10], rtol=1e-6)
    np.testing.assert_allclose(ours[110], ref["lrs"][110], rtol=1e-3)


class MLPEncoder(nn.Module):
    """The recorder's two-layer MLP (exact GELU), from its recorded weights."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.fc1 = nn.Linear(w1.shape[1], w1.shape[0])
        self.fc2 = nn.Linear(w2.shape[1], w2.shape[0])
        with torch.no_grad():
            for layer, w, b in ((self.fc1, w1, b1), (self.fc2, w2, b2)):
                layer.weight.copy_(torch.from_numpy(w))
                layer.bias.copy_(torch.from_numpy(b))

    def forward(self, x):
        y = self.fc2(nn.functional.gelu(self.fc1(x)))
        return EncoderOutput(last_hidden_state=y[:, None, :], pooler_output=y)


class Recorder:
    def __init__(self):
        self.losses, self.scales, self.lrs = [], [], []

    def on_train_start(self, trainer): ...

    def on_train_batch_end(self, trainer, metrics, step):
        if "loss" in metrics:
            self.losses.append(metrics["loss"])
            self.scales.append(metrics["logit_scale"])
            self.lrs.append(metrics["lr"])

    def on_train_epoch_end(self, trainer, epoch): ...

    def on_validation_end(self, trainer, metrics, step): ...

    def on_train_end(self, trainer): ...


def test_contrastive_training_trajectory_matches_reference(tmp_path):
    """50 steps of the recorded MLP pair through ``Trainer.fit``: losses rtol
    1e-4 for 10 steps and 5e-3 over 50, the LR monitor's rates 1e-4, logit
    scales 5e-3, the final probe embeddings atol 2e-3."""
    fx = np.load(os.path.join(FIXTURES, "reference_contrastive_trajectory.npz"))
    c = TRAJ
    rgb, txt, probe_rgb, probe_txt, ids = make_trajectory_data()
    encoders = {m: MLPEncoder(*(fx[f"w_{m}.{layer}.{kind}"] for layer in ("fc1", "fc2")
                                for kind in ("weight", "bias")))
                for m in ("rgb", "text")}
    task = ContrastivePretraining(
        encoders,
        optimizer=functools.partial(torch.optim.AdamW, betas=c["betas"], eps=c["eps"],
                                    weight_decay=c["weight_decay"]),
        lr_scheduler=functools.partial(
            linear_warmup_cosine_annealing_lr, base_lr=c["lr"], warmup_steps=c["warmup_steps"],
            max_steps=c["steps"], start_factor=c["start_factor"], eta_min=c["eta_min"]),
    )
    batches = [{"rgb": rgb[i], "text": txt[i], "example_ids": {"rgb": ids, "text": ids}}
               for i in range(c["n_batches"])]
    rec = Recorder()
    trainer = Trainer(max_steps=c["steps"], log_every_n_steps=1,
                      callbacks=[LearningRateMonitor(), rec], default_root_dir=str(tmp_path),
                      device="cpu")
    state = trainer.fit(task, batches)
    assert state.step == c["steps"] and len(rec.losses) == c["steps"]
    np.testing.assert_allclose(rec.losses[:10], fx["losses"][:10], rtol=1e-4)
    np.testing.assert_allclose(rec.losses, fx["losses"], rtol=5e-3)
    np.testing.assert_allclose(rec.lrs, fx["lrs"], rtol=1e-4)
    np.testing.assert_allclose(rec.scales, np.exp(fx["log_scales"]), rtol=5e-3)
    task.eval()
    with torch.no_grad():
        out = task.forward({"rgb": probe_rgb, "text": probe_txt})
    np.testing.assert_allclose(out["rgb_embedding"].numpy(), fx["final_rgb"], atol=2e-3)
    np.testing.assert_allclose(out["text_embedding"].numpy(), fx["final_text"], atol=2e-3)
