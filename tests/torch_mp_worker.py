"""One process of the port's multi-process tests (``tests/test_torch_parallel.py``):
rank and world from the environment that ``mmlearn_tpu_torch.parallel.mp_launch``
sets, gloo on the CPU. Runs every scenario in one process group and writes
what the parent test compares under ``<outdir>``:

- ``fit_data`` / ``fit_fsdp``: 6 steps of the tiny pair (SGD, clipped by the
  global norm at :data:`CLIP`) at ``data=2`` and at ``fsdp=2`` on the global
  batches of :func:`batches`: losses, gradient norms and weights;
- ``loss``: the contrastive loss and its embedding gradients through the
  gather, global and ``local_loss``;
- ``eval``: ``Trainer.validate`` with zero-shot retrieval and an embedding
  export over 53 examples (shards of 27 and 26), and the classification
  metrics over each rank's scores;
- ``ckpt``: 2 steps at ``fsdp=2`` saved by ``ModelCheckpoint``;
- ``ring``: the ring over ``batch_isend_irecv``, causal and not;
- ``seq``: the attention layer on a ``seq=2`` group, output and gradients;
- ``dryrun``: the flagship dry run's step (``flagship.dryrun_step``).

Run as: ``python tests/torch_mp_worker.py <outdir>`` under ``run_workers``.
Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

GLOBAL_BATCH = 8
STEPS = 6
#: the fits' ``gradient_clip_val``: below the global norm of the first steps
#: (28.1, 3.6, 1.03 in one process), so those steps are clipped
CLIP = 1.0


def batches(n: int = STEPS, seed: int = 0) -> list[dict]:
    """``n`` global batches of the tiny pair's inputs (32-px images, 16
    tokens ending in the end-of-text id 63)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 62, (GLOBAL_BATCH, 16)).astype(np.int32)
        ids[:, -1] = 63
        out.append({"rgb": rng.standard_normal((GLOBAL_BATCH, 32, 32, 3)).astype(np.float32),
                    "text": ids})
    return out


class Loader:
    """A sized loader of fixed global batches (no sampler: the trainer cuts
    each to the rank's rows)."""

    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter([dict(b) for b in self.data])


class Capture:
    """The logged losses and gradient norms by step."""

    def __init__(self):
        self.losses = []
        self.grad_norms = []

    def on_train_start(self, trainer): ...

    def on_train_batch_end(self, trainer, metrics, step):
        if "loss" in metrics:
            self.losses.append(float(metrics["loss"]))
            self.grad_norms.append(float(metrics["grad_norm"]))

    def on_train_epoch_end(self, trainer, epoch): ...

    def on_validation_end(self, trainer, metrics, step): ...

    def on_train_end(self, trainer): ...


def sgd_task():
    """The tiny flagship pair with SGD (linear in the gradient: a rounding
    difference between layouts stays a rounding difference in the weights)."""
    from mmlearn_tpu_torch.flagship import tiny_training_task

    task = tiny_training_task(seed=0)
    task.optimizer_factory = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    task.lr_scheduler_factory = None
    return task


def flat_params(task) -> np.ndarray:
    """Every parameter whole (gathered from its shards), in name order."""
    from mmlearn_tpu_torch.trainer.state import full_state

    sd = full_state({n: p.detach() for n, p in task.named_parameters()})
    return np.concatenate([sd[n].reshape(-1).double().numpy() for n in sorted(sd)])


def fit(mesh_shape, steps=STEPS, callbacks=(), root="root"):
    """The tiny pair's fit; returns the task and the :class:`Capture`."""
    from mmlearn_tpu_torch.trainer import Trainer

    capture = Capture()
    trainer = Trainer(max_steps=steps, log_every_n_steps=1, mesh_shape=mesh_shape,
                      callbacks=[capture, *callbacks], device="cpu", seed=0,
                      default_root_dir=root, gradient_clip_val=CLIP)
    task = sgd_task()
    trainer.fit(task, Loader(batches()))
    return task, capture


def loss_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    za, zb = (rng.standard_normal((GLOBAL_BATCH, 16)).astype(np.float32) for _ in range(2))
    presence = np.ones(GLOBAL_BATCH, bool)
    presence[[1, 6]] = False
    return za, zb, presence


def scenario_loss(rank, world, out):
    from mmlearn_tpu_torch.modules.losses.contrastive import ContrastiveLoss, LossPairSpec
    from mmlearn_tpu_torch.parallel.mesh import create_mesh, set_global_mesh

    set_global_mesh(create_mesh(data=world, device="cpu"))
    za, zb, presence = loss_inputs()
    rows = slice(rank * GLOBAL_BATCH // world, (rank + 1) * GLOBAL_BATCH // world)
    for local in (False, True):
        a = torch.tensor(za[rows], requires_grad=True)
        b = torch.tensor(zb[rows], requires_grad=True)
        loss, _ = ContrastiveLoss(l2_normalize=True, local_loss=local)(
            {"rgb": a, "text": b}, None, torch.tensor(10.0), [LossPairSpec(("rgb", "text"))],
            presence={"rgb": torch.tensor(presence[rows]), "text": torch.tensor(presence[rows])})
        loss.backward()
        tag = "local" if local else "global"
        out[f"loss_{tag}_{rank}"] = loss.detach().numpy()
        out[f"grad_a_{tag}_{rank}"] = a.grad.numpy()
        out[f"grad_b_{tag}_{rank}"] = b.grad.numpy()
    set_global_mesh(None)


def scenario_eval(rank, world, outdir, out):
    from mmlearn_tpu_torch.datasets.builtin.synthetic import SyntheticImageText
    from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader
    from mmlearn_tpu_torch.datasets.core.samplers import DistributedEvalSampler
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh
    from mmlearn_tpu_torch.tasks.contrastive_pretraining import EvaluationSpec
    from mmlearn_tpu_torch.tasks.embedding_export import EmbeddingExport
    from mmlearn_tpu_torch.tasks.zero_shot_classification import ZeroShotClassification
    from mmlearn_tpu_torch.tasks.zero_shot_retrieval import (
        RetrievalTaskSpec,
        ZeroShotCrossModalRetrieval,
    )
    from mmlearn_tpu_torch.trainer import Trainer

    task = sgd_task()
    task.evaluation_tasks = {
        "retrieval": EvaluationSpec(task=ZeroShotCrossModalRetrieval(
            [RetrievalTaskSpec(query_modality="rgb", target_modality="text", top_k=[1, 5])])),
        "export": EvaluationSpec(task=EmbeddingExport(
            output_dir=os.path.join(outdir, "index"), modalities=["rgb"], shard_size=8)),
    }
    task.compute_validation_loss = True
    ds = CombinedDataset([SyntheticImageText(size=53, image_size=32, seq_len=16,
                                             vocab_size=64, num_classes=4)])
    loader = DataLoader(ds, batch_size=8, sampler=DistributedEvalSampler(ds),
                        pad_partial_batches=True)
    trainer = Trainer(mesh_shape={"data": world}, device="cpu", seed=0,
                      default_root_dir=os.path.join(outdir, "eval_root"))
    trainer.prepare_eval_state(task, loader)
    results = trainer.validate(task, loader)
    for key, value in results.items():
        out[f"eval/{key}"] = np.asarray(value)

    # the classification metrics over each rank's rows of a fixed set of scores
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((53, 4)).astype(np.float32)
    targets = rng.integers(0, 4, 53)
    mine = np.arange(rank, 53, world)
    hook = ZeroShotClassification.__new__(ZeroShotClassification)
    hook.task_specs = []
    hook._class_embeddings = {}
    hook._scores = {("rgb", 0): [(torch.tensor(scores[mine]), torch.tensor(targets[mine]),
                                  torch.ones(len(mine), dtype=torch.bool))]}
    for key, value in hook.on_evaluation_epoch_end(None).items():
        out[f"cls/{key}"] = np.asarray(value)
    set_global_mesh(None)


def scenario_ckpt(rank, world, outdir):
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh
    from mmlearn_tpu_torch.trainer import ModelCheckpoint

    ckpt = ModelCheckpoint(dirpath=os.path.join(outdir, "ckpt"), save_last=True,
                           async_save=False)
    fit({"data": 1, "fsdp": world}, steps=2, callbacks=[ckpt],
        root=os.path.join(outdir, "ckpt_root"))
    set_global_mesh(None)


def ring_inputs(seed: int = 11, n: int = 64, d: int = 16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 4, n, d)).astype(np.float32) for _ in range(3))


def scenario_ring(rank, world, out):
    from mmlearn_tpu_torch.ops.ring_attention import GroupExchange, ring_attention

    ex = GroupExchange(dist.group.WORLD)
    q, k, v = ring_inputs()
    n = q.shape[2] // world
    for causal in (False, True):
        blocks = [torch.tensor(x[:, :, rank * n:(rank + 1) * n], requires_grad=True)
                  for x in (q, k, v)]
        o = ring_attention(*blocks, 16 ** -0.5, causal, ex)
        (o * torch.cos(o)).sum().backward()
        tag = f"ring_{int(causal)}_{rank}"
        out[f"{tag}_out"] = o.detach().numpy()
        for name, t in zip("qkv", blocks):
            out[f"{tag}_d{name}"] = t.grad.numpy()
    out[f"ring_hops_{rank}"] = np.array([ex.hops["forward"], ex.hops["backward"],
                                         ex.hops["skipped"]])


def scenario_seq(rank, world, out):
    """The attention layer on a ``seq`` group of ``world`` ranks: every rank
    holds the whole input, its block goes through the ring."""
    from mmlearn_tpu_torch.modules.layers.attention import Attention
    from mmlearn_tpu_torch.parallel.mesh import create_mesh, set_global_mesh

    torch.manual_seed(0)
    attn = Attention(64, num_heads=4, qkv_bias=True)
    x = torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 64)).astype(np.float32),
                     requires_grad=True)
    set_global_mesh(create_mesh(data=1, seq=world, device="cpu"))
    y = attn(x)
    (y * y).sum().backward()
    out[f"seq_out_{rank}"] = y.detach().numpy()
    out[f"seq_dx_{rank}"] = x.grad.numpy()
    out[f"seq_dw_{rank}"] = attn.qkv.weight.grad.numpy()
    set_global_mesh(None)


def main() -> None:
    from mmlearn_tpu_torch.parallel.mesh import init_from_env, set_global_mesh

    outdir = sys.argv[1]
    init_from_env("cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    out: dict[str, np.ndarray] = {}
    for name, shape in (("data", {"data": world}), ("fsdp", {"data": 1, "fsdp": world})):
        task, capture = fit(shape, root=os.path.join(outdir, f"root_{name}"))
        out[f"fit_{name}_losses_{rank}"] = np.asarray(capture.losses)
        out[f"fit_{name}_grad_norms_{rank}"] = np.asarray(capture.grad_norms)
        out[f"fit_{name}_params_{rank}"] = flat_params(task)
        set_global_mesh(None)
    scenario_loss(rank, world, out)
    scenario_eval(rank, world, outdir, out)
    scenario_ckpt(rank, world, outdir)
    scenario_ring(rank, world, out)
    scenario_seq(rank, world, out)
    from mmlearn_tpu_torch.flagship import dryrun_step

    out[f"dryrun_loss_{rank}"] = np.asarray(dryrun_step())
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"torch_mp_worker rank {rank}/{world} OK", flush=True)


if __name__ == "__main__":
    main()
