"""The trainer on the card: phase 9's resume check of ``chip_smoke.py`` at
micro-batches of 8, and the FLOP counter on the card against the CPU.

Both need a CUDA card and skip without one. The file imports neither JAX
nor the JAX package, so that it runs on the card's host:
``python -m pytest -m cuda tests/test_torch_trainer_card.py``.
"""

import functools
import os

import pytest
import torch

from mmlearn_tpu_torch.flagship import flagship_training_task, synthetic_batch
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from mmlearn_tpu_torch.trainer import ModelCheckpoint, Trainer
from mmlearn_tpu_torch.trainer.flops import count_flops


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")


class Pairs:
    """4 distinct synthetic flagship micro-batches of 8 a pass, drawn on the
    card from (epoch, index)."""

    def __init__(self):
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return 4

    def __iter__(self):
        for i in range(4):
            g = torch.Generator(device="cuda").manual_seed(self.epoch * 100 + i)
            yield synthetic_batch(8, g, "cuda")


class StopAt:
    def __init__(self, step):
        self.step = step

    def on_train_start(self, trainer): ...

    def on_train_batch_end(self, trainer, metrics, step):
        trainer.should_stop = step == self.step

    def on_train_epoch_end(self, trainer, epoch): ...

    def on_validation_end(self, trainer, metrics, step): ...

    def on_train_end(self, trainer): ...


@pytest.mark.cuda
def test_cuda_flagship_resume_is_bit_equal(tmp_path):
    """The flagship with the kernels at k=2: 6 micro-steps straight, and 3
    (a window left open), a checkpoint and 3 resumed, give the same records
    and weights bit for bit."""
    _need_card()

    def run(callbacks=(), ckpt_path=None):
        task = flagship_training_task("cuda", seed=0)
        trainer = Trainer(max_steps=6, accumulate_grad_batches=2, gradient_clip_val=1.0,
                          log_every_n_steps=1, callbacks=list(callbacks), device="cuda")
        trainer.fit(task, Pairs(), ckpt_path=ckpt_path)
        return trainer.history, {k: v.cpu() for k, v in task.state_dict().items()}

    full, weights = run()
    ck = str(tmp_path / "ck")
    first, _ = run([StopAt(3), ModelCheckpoint(ck)])
    rest, resumed = run([ModelCheckpoint(ck)], ckpt_path="last")
    assert os.listdir(ck) and first + rest == full
    for name, value in weights.items():
        assert torch.equal(resumed[name], value), name


@pytest.mark.cuda
def test_cuda_step_counts_the_flops_of_the_cpu_step():
    """The counter counts the same FLOPs for a step through the kernels on
    the card (each Function reporting) as through the plain versions on the
    CPU (``FlopCounterMode`` seeing their products)."""
    _need_card()
    vision = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
                  use_cls_token=True, global_pool="cls", proj_dim=16)
    text = dict(vocab_size=64, max_length=16, embed_dim=128, depth=2, num_heads=2,
                causal=True, pooling="eos", proj_dim=16)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(2, 62, (4, 16), generator=g, dtype=torch.int32)
    ids[:, -1] = 63
    batch = {"rgb": torch.randn(4, 32, 32, 3, generator=g), "text": ids}
    counts = {}
    for device in ("cpu", "cuda"):
        g = torch.Generator().manual_seed(0)
        task = ContrastivePretraining(
            {"rgb": VisionTransformer(**vision, generator=g),
             "text": TextTransformer(**text, generator=g)},
            optimizer=functools.partial(torch.optim.AdamW, lr=1e-3)).to(device)
        _, counts[device] = count_flops(lambda: task.loss_fn(batch)[0].backward())
    assert counts["cuda"] == counts["cpu"] > 0
