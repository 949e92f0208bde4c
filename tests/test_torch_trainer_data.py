"""The port's trainer on the data layer, on the CPU: the counterparts of
``tests/tasks/test_device_normalize.py`` (the uint8 path against the host
float path, an unconfigured uint8 image raising), ``overfit_batches`` (as
``tests/tasks/test_trainer_behaviors.py`` holds it), a resumed epoch's
fast-forward that fetches no skipped example and ends bit-equal to the
uninterrupted run, and the slice as a whole: a tiny flagship (2 blocks,
width 64) takes 3 steps in the JAX ``Trainer`` over the JAX ``DataLoader``
and in the port's over the port's, on the same uint8 data normalized on the
device, the weights bridged from the JAX init. Each test states its
tolerance.
"""

import functools
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.datasets.builtin import image_utils as jimage_utils
from mmlearn_tpu.datasets.core import CombinedDataset as JCombined
from mmlearn_tpu.datasets.core import DataLoader as JLoader
from mmlearn_tpu.datasets.core import tfrecord as jtfrecord
from mmlearn_tpu.datasets.core.example import Example as JExample
from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.lr_schedulers import linear_warmup_cosine_annealing_lr as jax_schedule
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.trainer import Trainer as JTrainer
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin import image_utils
from mmlearn_tpu_torch.datasets.core import (
    CombinedDataset,
    CombinedDatasetRatioSampler,
    DataLoader,
    Example,
    SequentialSampler,
    tfrecord,
)
from mmlearn_tpu_torch.modules.encoders import VisionTransformer
from mmlearn_tpu_torch.trainer import ModelCheckpoint, Trainer
from mmlearn_tpu_torch.trainer.trainer import compute_dtype
from tests.test_torch_process_loader import JpegPairs, write_jpeg_shards
from tests.test_torch_trainer_fit import SCHEDULE, TEXT, VISION, Recorder, port_task

MEAN = (0.2, 0.3, 0.4)
STD = (0.5, 0.6, 0.7)
NORMALIZE = {"rgb": {"mean": MEAN, "std": STD}}


class Pairs:
    """Image-text pairs of the tiny towers, class k with image pattern k
    and token k, as ``Example``s of ``example_cls``: uint8 images (the float
    pattern quantized over [-3, 3]), or with ``host_float`` the same bytes
    normalized on the host. Records the indices it fetched."""

    def __init__(self, example_cls=Example, size=24, host_float=False, seed=0):
        rng = np.random.default_rng(seed)
        self.example_cls, self.size, self.host_float = example_cls, size, host_float
        self.labels = rng.integers(0, 6, size)
        self.patterns = rng.standard_normal((6, 16, 16, 3)).astype(np.float32)
        self.fetched: list[int] = []

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        self.fetched.append(int(idx))
        k = self.labels[idx]
        img = self.patterns[k] + 0.05 * np.random.default_rng(idx).standard_normal(
            (16, 16, 3)).astype(np.float32)
        img = (np.clip((img + 3.0) / 6.0, 0, 1) * 255.0).astype(np.uint8)
        if self.host_float:
            img = (img.astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32)) / np.asarray(
                STD, np.float32)
        ids = np.full((8,), k + 2, dtype=np.int32)
        ids[0] = 1
        ids[-1] = 31  # end of text: the row maximum
        return self.example_cls({"rgb": img, "text": ids,
                                 "text_attention_mask": np.ones(8, np.int32),
                                 EXAMPLE_INDEX_KEY: int(idx)})


def fit(loader, max_steps, device_normalize=None, callbacks=(), ckpt_path=None, **kw):
    """The tiny pair trained over ``loader``: the trainer, the task, the
    losses and the example indices of every step's batch."""
    task = port_task()
    seen = []
    prepare = task.prepare_batch

    def record(batch, step, training=True):
        if training:
            seen.append(batch[EXAMPLE_INDEX_KEY].tolist())
        return prepare(batch, step, training)

    task.prepare_batch = record
    rec = Recorder()
    trainer = Trainer(max_steps=max_steps, log_every_n_steps=1, device="cpu",
                      device_normalize=device_normalize, callbacks=[rec, *callbacks], **kw)
    trainer.fit(task, loader, ckpt_path=ckpt_path)
    return trainer, task, rec.series("loss"), seen


# ------------------------------------------------------- device normalization


def test_uint8_path_matches_host_float_path():
    """The same bytes normalized on the device and on the host give the
    same losses (rtol 1e-5, the JAX test's limit)."""
    def loader(ds):
        return DataLoader(CombinedDataset([ds]), batch_size=8, drop_last=True)

    _, _, dev, _ = fit(loader(Pairs()), 4, NORMALIZE)
    _, _, host, _ = fit(loader(Pairs(host_float=True)), 4)
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-5)


def test_unconfigured_uint8_image_raises():
    with pytest.raises(ValueError, match="device_normalize"):
        fit(DataLoader(CombinedDataset([Pairs()]), batch_size=8), 1)


def test_device_inputs_dtype_rank_and_exact_arithmetic():
    """uint8 of rank 3 or more under a configured key: the host's f32
    normalization exactly, in the task's compute dtype (bf16 where its
    towers compute in bf16); lower-rank uint8 and integers pass; floats,
    nested ones too, are cast."""
    bf16_task = torch.nn.ModuleDict({"rgb": VisionTransformer(**VISION, dtype=torch.bfloat16)})
    assert compute_dtype(bf16_task) == torch.bfloat16
    assert compute_dtype(port_task()) == torch.float32
    x = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    want = (x.astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32)) / np.asarray(
        STD, np.float32)
    batch = {"rgb": torch.from_numpy(x), "small": torch.zeros(3, dtype=torch.uint8),
             "text": torch.ones(2, 3, dtype=torch.int32),
             "nested": {"w": torch.ones(2, dtype=torch.float64)}, "names": ["a", "b"]}
    trainer = Trainer(device="cpu", device_normalize=NORMALIZE)
    out = trainer._device_inputs(batch, torch.float32)
    assert torch.equal(out["rgb"], torch.from_numpy(want))
    out = trainer._device_inputs(batch, torch.bfloat16)
    assert torch.equal(out["rgb"], torch.from_numpy(want).to(torch.bfloat16))
    assert out["small"] is batch["small"] and out["text"] is batch["text"]
    assert out["nested"]["w"].dtype == torch.bfloat16 and out["names"] == ["a", "b"]


# --------------------------------------------------------------- overfit


def test_overfit_batches(tmp_path):
    """The same leading batches every epoch (the shuffling sampler
    downgraded), validated on themselves at each epoch end."""
    ds = CombinedDataset([Pairs(size=32)])
    train = DataLoader(ds, batch_size=8, drop_last=True, shuffle=True)
    val = DataLoader(ds, batch_size=8, drop_last=True)
    rec = Recorder()
    trainer = Trainer(max_epochs=2, overfit_batches=2, log_every_n_steps=1, device="cpu",
                      device_normalize=NORMALIZE, callbacks=[rec])
    trainer.fit(port_task(), train, val)
    assert sorted(rec.metrics) == [1, 2, 3, 4] and rec.val_steps == [2, 4]
    assert isinstance(train.sampler, SequentialSampler)
    assert trainer.limit_train_batches == 2 and trainer.limit_val_batches == 2
    with pytest.raises(ValueError, match="overfit_batches"):
        Trainer(overfit_batches=-1)


def test_overfit_batches_pins_an_epoch_seeded_sampler():
    ds = CombinedDataset([Pairs(size=32)])
    sampler = CombinedDatasetRatioSampler(ds, shuffle=True, seed=0)
    loader = DataLoader(ds, batch_size=8, sampler=sampler, drop_last=True)
    _, _, _, seen = fit(loader, None, NORMALIZE, max_epochs=2, overfit_batches=2)
    assert len(seen) == 4 and seen[:2] == seen[2:]


# ------------------------------------------------------ resume, fast-forward


@pytest.mark.parametrize("fast", [True, False], ids=["iter_from_batch", "fetch_and_discard"])
def test_resume_skips_no_example_fetch_and_equals_the_full_run(tmp_path, fast):
    """An epoch of 6 shuffled batches; a run resumed from the step-3
    checkpoint takes steps 3-5 on the same examples and ends with the same
    weights bit for bit. Through ``iter_from_batch`` it fetches only those
    steps' 12 examples, none of the skipped batches'; a loader without it
    fetches and discards all 24."""
    def loader():
        inner = Pairs(size=24)
        ds = CombinedDataset([inner]) if fast else inner
        return inner, DataLoader(ds, batch_size=4, drop_last=True, shuffle=True, seed=5,
                                 prefetch_factor=1)

    ck = str(tmp_path / "ck")
    _, full_loader = loader()
    _, task, losses, seen = fit(full_loader, 6, NORMALIZE, callbacks=[
        ModelCheckpoint(ck, every_n_train_steps=3, every_n_epochs=None)])
    resume = str(tmp_path / "resume")
    shutil.copytree(os.path.join(ck, "3"), os.path.join(resume, "3"))
    shutil.copy(os.path.join(ck, "loop_position-3.json"), resume)
    inner, loader_r = loader()
    trainer, task_r, losses_r, seen_r = fit(loader_r, 6, NORMALIZE, ckpt_path=resume)
    assert trainer.restored_step == 3 and seen_r == seen[3:]
    np.testing.assert_array_equal(losses_r, losses[3:])
    for name, value in task.state_dict().items():
        assert torch.equal(task_r.state_dict()[name], value), name
    skipped = {i for batch in seen[:3] for i in batch}
    if fast:
        assert not skipped & set(inner.fetched) and len(inner.fetched) == 12
    else:
        assert skipped <= set(inner.fetched) and len(inner.fetched) == 24


# ------------------------------------------------------------ the whole slice


def run_slice(tmp_path, jax_loader, port_loader, near_zero_grads=False):
    """3 steps of the tiny flagship from the same weights, the JAX
    ``Trainer`` over ``jax_loader`` against the port's over
    ``port_loader``, both normalizing uint8 images on the device, held to
    the limits of ``tests/test_torch_trainer_fit.py``: loss rtol 1e-5 at the
    first step and 3e-4 over all, the final weights atol 2e-5 (the key
    projection's bias, trained on rounding noise, to twice the sum of the
    rates).

    With ``near_zero_grads``, a weight whose gradient at some step is nonzero
    and below 1e-6 (100 x AdamW's epsilon, where its update ``g / (|g| + eps)`` turns
    the f32 rounding of a near-cancelling sum into a visible step) is held
    to that same bound, and such weights (the key bias aside) must be fewer
    than 1 in 1,000."""
    jtask = JTask(encoders={"rgb": JVision(**VISION), "text": JText(**TEXT)},
                  optimizer=functools.partial(optax.adamw, weight_decay=0.01),
                  lr_scheduler=functools.partial(jax_schedule, **SCHEDULE))
    sample = {"rgb": np.zeros((4, 16, 16, 3), np.float32), "text": np.ones((4, 8), np.int32)}
    params = jax.device_get(jtask.init_params(jax.random.key(0), sample))
    jtask.init_overlay = params
    jrec = Recorder()
    jtrainer = JTrainer(max_steps=3, log_every_n_steps=1, callbacks=[jrec],
                        mesh_shape={"data": 1}, device_normalize=NORMALIZE,
                        default_root_dir=str(tmp_path / "jax"), seed=0)
    jstate = jtrainer.fit(jtask, jax_loader)

    task = port_task()
    task.load_state_dict(bridge.jax_to_torch(params), strict=True)
    least_grad = {}  # name -> the least nonzero |gradient| over the steps, element-wise
    if near_zero_grads:
        for name, param in task.named_parameters():
            def note(grad, name=name):
                g = grad.detach().abs()
                g[g == 0] = float("inf")  # an exact zero moves no weight
                least_grad[name] = torch.minimum(least_grad[name], g) if name in least_grad else g
            param.register_hook(note)
    rec = Recorder()
    trainer = Trainer(max_steps=3, log_every_n_steps=1, callbacks=[rec],
                      device_normalize=NORMALIZE, device="cpu")
    state = trainer.fit(task, port_loader)

    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(rec.series("loss")[0], jrec.series("loss")[0], rtol=1e-5)
    np.testing.assert_allclose(rec.series("loss"), jrec.series("loss"), rtol=3e-4)
    want = bridge.jax_to_torch(jax.device_get(jstate.params))
    key_bias = np.zeros((4, 3, 16), bool)
    key_bias[:, 1] = True
    noise_bound = 2 * sum(trainer._lr_schedule(i) for i in range(3))
    n_near_zero = n_weights = 0
    for name, value in task.state_dict().items():
        got, ref = value.numpy().ravel(), want[name].numpy().ravel()
        soft = np.zeros(got.shape, bool)
        if name.endswith("attn.qkv.bias"):
            soft |= key_bias.reshape(-1)
        if name in least_grad:
            near_zero = (least_grad[name].numpy().ravel() < 1e-6) & ~soft
            n_near_zero += int(near_zero.sum())
            soft |= near_zero
        n_weights += got.size
        np.testing.assert_array_less(np.abs(got - ref)[soft], noise_bound)
        np.testing.assert_allclose(got[~soft], ref[~soft], atol=2e-5, err_msg=name)
    assert n_near_zero * 1000 < n_weights, n_near_zero


def test_slice_matches_the_jax_trainer_on_uint8_data(tmp_path):
    """The same uint8 batches (a shuffled loader), the JAX ``DataLoader``
    against the port's (see :func:`run_slice`)."""
    def loader(example_cls, combined, loader_cls):
        return loader_cls(combined([Pairs(example_cls, size=16)]), batch_size=4,
                          drop_last=True, shuffle=True, seed=1, num_workers=2)

    run_slice(tmp_path, loader(JExample, JCombined, JLoader),
              loader(Example, CombinedDataset, DataLoader))


def test_slice_matches_the_jax_trainer_on_tfrecord_jpegs(tmp_path):
    """The slice from TFRecord shards of the JPEG fixtures (16 records in 4
    shards), each decoded and cropped to 16 px by the native train path
    under its record's seed, uint8: the JAX ``TFRecordDataset``, decoder
    and ``DataLoader`` against the port's (see :func:`run_slice`; here one
    weight of the text tower's first fc2 has a first-step gradient of
    -2.5e-8, where AdamW's epsilon amplifies rounding)."""
    tokens = np.tile(np.arange(4)[:, None] + 2, (1, 8)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 31  # end of text: the row maximum
    shards = write_jpeg_shards(tmp_path, n=16, shards=4, tokens=tokens)

    def loader(tfrecord, image_utils, example_cls, combined, loader_cls):
        transform = image_utils.ImageTransform(size=16, train=True, device_normalize=True)
        ds = tfrecord.TFRecordDataset(shards, verify_crc=True, to_example=JpegPairs(
            transform, image_utils.decode_transform_jpeg, example_cls))
        return loader_cls(combined([ds]), batch_size=4, drop_last=True, shuffle=True, seed=1,
                          num_workers=2)

    run_slice(tmp_path, loader(jtfrecord, jimage_utils, JExample, JCombined, JLoader),
              loader(tfrecord, image_utils, Example, CombinedDataset, DataLoader),
              near_zero_grads=True)
