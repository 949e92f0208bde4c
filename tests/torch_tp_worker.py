"""One process of the port's tensor-parallel tests
(``tests/test_torch_tensor_parallel.py``): rank and world (4) from the
environment that ``mmlearn_tpu_torch.parallel.mp_launch`` sets, gloo on the
CPU. Runs every scenario in one process group, each on a mesh of its own
with a ``model`` axis of 2, and writes what the parent test compares under
``<outdir>``:

- ``attn``: the attention layer at ``data=2, model=2`` on three head
  layouts (4 heads of D=64 on the fused route, 2 on the plain route its
  sharded plan gives, 3 of D=32 whose split is not on whole heads), with and
  without a key mask: the output, ``proj``'s input and the gradient of
  ``qkv``'s output; the returned weights (every head's); ``MMLEARN_QUANT``
  raising on the split layers; a block
  with every dropout and drop-path (:func:`dropout_block`);
- ``fit``: 6 clipped SGD steps of the tiny pair at ``fsdp=2, model=2``
  (losses, gradient norms, the weights gathered, every parameter's
  placement);
- ``seq``: its first 3 steps at ``data=1, seq=2, model=2``;
- ``bioscan``: the BIOSCAN-CLIP fixture trajectory (BERT towers, LoRA,
  one-cycle) at ``data=2, model=2`` from the inputs the parent wrote;
- ``ijepa``: 3 steps of a tiny I-JEPA task at ``data=2, model=2``
  (:func:`ijepa_fit`): the student, predictor and EMA teacher split alike;
- ``ckpt``: 2 steps at ``fsdp=2, model=2`` saved by ``ModelCheckpoint``;
- ``eval``: ``Trainer.validate`` with retrieval and an export at ``data=2,
  model=2``, and the classification metrics over each batch shard's scores;
- ``dryrun``: the flagship dry run's step on 4 processes (``fsdp=2,
  model=2``);
- ``bridge``: a whole state dict loaded into a parallelized task and
  gathered back to the JAX layout.

Run as: ``python tests/torch_tp_worker.py <outdir>`` under ``run_workers``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch_mp_worker as base  # noqa: E402

#: the attention scenario's layouts: (heads, head dim)
ATTN_CASES = ((4, 64), (2, 64), (3, 32))
ATTN_BATCH, ATTN_SEQ = 4, 16
FIT_MESH = {"data": 1, "fsdp": 2, "model": 2}
SEQ_MESH = {"data": 1, "seq": 2, "model": 2}
SEQ_STEPS = 3  # test_end_to_end.py's seq-mesh fit
BIOSCAN_MESH = {"data": 2, "model": 2}
IJEPA_MESH = {"data": 2, "model": 2}


def attn_inputs(heads: int, head_dim: int, seed: int = 21) -> dict[str, np.ndarray]:
    """The attention scenario's weights (JAX layout: ``(in, out)`` kernels),
    input, key mask and output cotangent of ``proj``'s input."""
    rng = np.random.default_rng(seed + heads * 100 + head_dim)
    c = heads * head_dim
    mask = np.ones((ATTN_BATCH, ATTN_SEQ), bool)
    mask[1, 11:] = False
    mask[2, 3:] = False
    mask[3, 7:] = False
    return {
        "qkv_kernel": (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32),
        "qkv_bias": (0.1 * rng.standard_normal(3 * c)).astype(np.float32),
        "proj_kernel": (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        "proj_bias": rng.standard_normal(c).astype(np.float32),
        "x": rng.standard_normal((ATTN_BATCH, ATTN_SEQ, c)).astype(np.float32),
        "mask": mask,
        "g": rng.standard_normal((ATTN_BATCH, ATTN_SEQ, c)).astype(np.float32),
    }


def scenario_attention(rank, out):
    from mmlearn_tpu_torch.modules.layers.attention import Attention
    from mmlearn_tpu_torch.ops.fused_attention import PLAIN_ROUTE
    from mmlearn_tpu_torch.parallel.mesh import create_mesh, set_global_mesh
    from mmlearn_tpu_torch.parallel.partitioning import infer_param_specs
    from mmlearn_tpu_torch.parallel.tensor_parallel import parallelize

    mesh = create_mesh(data=2, model=2, device="cpu")
    set_global_mesh(mesh)
    rows = slice(mesh.dp_rank * 2, mesh.dp_rank * 2 + 2)
    for heads, d in ATTN_CASES:
        inp = attn_inputs(heads, d)
        attn = Attention(heads * d, heads, qkv_bias=True)
        attn.load_state_dict({"qkv.weight": torch.tensor(inp["qkv_kernel"].T),
                              "qkv.bias": torch.tensor(inp["qkv_bias"]),
                              "proj.weight": torch.tensor(inp["proj_kernel"].T),
                              "proj.bias": torch.tensor(inp["proj_bias"])})
        # under a parent named ``attn``, as the rules' paths read
        layer = torch.nn.ModuleDict({"attn": attn})
        parallelize(layer, mesh, infer_param_specs(layer, mesh))
        seen = {}
        attn.qkv.register_forward_hook(lambda m, a, o: seen.__setitem__("qkv", o))
        attn.proj.register_forward_pre_hook(lambda m, a: seen.__setitem__("core", a[0]),
                                            prepend=True)
        for masked in (False, True):
            tag = f"attn_{heads}_{d}_{int(masked)}"
            before = PLAIN_ROUTE["xla"]
            x = torch.tensor(inp["x"][rows])
            mask = torch.tensor(inp["mask"][rows]) if masked else None
            y = attn(x, mask)
            core = seen["core"]
            g = torch.tensor(inp["g"][rows])
            if core.shape[-1] != g.shape[-1]:  # this rank's heads
                w = core.shape[-1]
                g = g[..., mesh.model_rank * w:(mesh.model_rank + 1) * w]
            (dqkv,) = torch.autograd.grad((core * g).sum(), seen["qkv"])
            out[f"{tag}_y_{rank}"] = y.detach().numpy()
            out[f"{tag}_core_{rank}"] = core.detach().numpy()
            out[f"{tag}_dqkv_{rank}"] = dqkv.numpy()
            out[f"{tag}_plain_{rank}"] = np.asarray(PLAIN_ROUTE["xla"] - before)
        with torch.no_grad():
            _, weights = attn(torch.tensor(inp["x"][rows]), return_weights=True)
        out[f"attn_{heads}_{d}_weights_{rank}"] = weights.numpy()
        os.environ["MMLEARN_QUANT"] = "int8_sb"
        try:
            attn(torch.tensor(inp["x"][rows]))
            out[f"attn_{heads}_{d}_quant_raised_{rank}"] = np.asarray("")
        except NotImplementedError as err:
            out[f"attn_{heads}_{d}_quant_raised_{rank}"] = np.asarray(str(err))
        finally:
            del os.environ["MMLEARN_QUANT"]
    block = dropout_block(mesh)
    out[f"block_y_{rank}"], out[f"block_dx_{rank}"] = block["y"], block["dx"]
    out[f"mlp_flops_{rank}"] = np.asarray(split_mlp_flops(mesh))
    set_global_mesh(None)


def split_mlp_flops(mesh) -> int:
    """The FLOPs ``FlopCounter`` counts for one forward of an MLP (64 to 256
    to 64 on 8 rows) split over ``mesh``'s ``model`` axis: the rank's share."""
    from mmlearn_tpu_torch.modules.layers.mlp import MLP
    from mmlearn_tpu_torch.parallel.partitioning import infer_param_specs
    from mmlearn_tpu_torch.parallel.tensor_parallel import parallelize
    from mmlearn_tpu_torch.trainer.flops import count_flops

    torch.manual_seed(5)
    layer = torch.nn.ModuleDict({"mlp": MLP(64, 64, hidden_dims=[256])})
    parallelize(layer, mesh, infer_param_specs(layer, mesh))
    _, flops = count_flops(layer["mlp"], torch.ones(8, 64))
    return flops


def dropout_block(mesh) -> dict[str, np.ndarray]:
    """A block with attention dropout, dropout and drop-path (0.1 each) in
    train mode on 2 samples, its masks from one seeded source; split over
    ``mesh``'s ``model`` axis where one is given (every rank on the whole
    batch). Returns its output and the input's gradient."""
    from mmlearn_tpu_torch.modules.layers.dropout import MaskSource, masks_from
    from mmlearn_tpu_torch.modules.layers.transformer_block import Block
    from mmlearn_tpu_torch.parallel.partitioning import infer_param_specs
    from mmlearn_tpu_torch.parallel.tensor_parallel import parallelize

    torch.manual_seed(3)
    block = Block(64, 4, mlp_ratio=2.0, qkv_bias=True, drop=0.1, attn_drop=0.1,
                  drop_path_rate=0.1).train()
    if mesh is not None:
        parallelize(block, mesh, infer_param_specs(block, mesh))
    x = torch.tensor(np.random.default_rng(4).standard_normal((2, 8, 64)).astype(np.float32),
                     requires_grad=True)
    with masks_from(MaskSource(7, "cpu")):
        y = block(x)
    (y * torch.cos(y)).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy()}


def placements(task) -> dict[str, dict[str, str]]:
    """``{parameter: {mesh axis: placement}}`` of a sharded task."""
    out = {}
    for name, p in task.named_parameters():
        if hasattr(p, "placements"):
            out[name] = {axis: str(pl) for axis, pl in zip(p.device_mesh.mesh_dim_names,
                                                           p.placements)}
        else:
            out[name] = {}
    return out


def scenario_fit(rank, outdir, out):
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh

    for name, shape, steps in (("fit", FIT_MESH, base.STEPS), ("seq", SEQ_MESH, SEQ_STEPS)):
        task, capture = base.fit(shape, steps=steps,
                                 root=os.path.join(outdir, f"root_{name}_{rank}"))
        out[f"{name}_losses_{rank}"] = np.asarray(capture.losses)
        out[f"{name}_grad_norms_{rank}"] = np.asarray(capture.grad_norms)
        if name == "fit":
            out[f"fit_params_{rank}"] = base.flat_params(task)
            if rank == 0:
                with open(os.path.join(outdir, "placements.json"), "w") as f:
                    json.dump(placements(task), f)
        set_global_mesh(None)


def ijepa_fit(mesh_shape, root: str):
    """3 steps of a tiny I-JEPA task (SGD with momentum; the EMA teacher,
    the predictor split as a tower) on 4 images a step; the trainer draws
    each step's masks for the global batch. Returns the losses and every
    parameter whole, the teacher's included."""
    import functools

    from mmlearn_tpu_torch.modules.encoders import VisionTransformer, VisionTransformerPredictor
    from mmlearn_tpu_torch.tasks import IJEPA
    from mmlearn_tpu_torch.trainer import Trainer

    torch.manual_seed(0)  # what the generators do not draw
    task = IJEPA(VisionTransformer(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4,
                                   generator=torch.Generator().manual_seed(0)),
                 VisionTransformerPredictor(num_patches=16, embed_dim=32, predictor_embed_dim=16,
                                            depth=1, num_heads=4),
                 optimizer=functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9),
                 ema_decay=0.9, ema_decay_end=0.99, ema_anneal_end_step=10,
                 generator=torch.Generator().manual_seed(1))
    batches = [{"rgb": np.random.default_rng(40 + i).standard_normal((4, 64, 64, 3))
                .astype(np.float32)} for i in range(3)]
    capture = base.Capture()
    Trainer(max_steps=3, log_every_n_steps=1, mesh_shape=mesh_shape, callbacks=[capture],
            device="cpu", seed=0, default_root_dir=root).fit(task, base.Loader(batches))
    return np.asarray(capture.losses), base.flat_params(task)


def scenario_ijepa(rank, outdir, out):
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh

    losses, params = ijepa_fit(IJEPA_MESH, os.path.join(outdir, f"ijepa_root_{rank}"))
    out[f"ijepa_losses_{rank}"], out[f"ijepa_params_{rank}"] = losses, params
    set_global_mesh(None)


def scenario_bioscan(rank, outdir, out):
    from mmlearn_tpu_torch.lightning_import import import_lightning_checkpoint
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh
    from mmlearn_tpu_torch.projects.bioscan_clip.recipe import bioscan_task
    from mmlearn_tpu_torch.trainer import LearningRateMonitor, Trainer

    inputs = np.load(os.path.join(outdir, "bioscan_inputs.npz"))
    c = json.loads(str(inputs["config"]))
    task = bioscan_task(
        rgb=dict(img_size=c["img"], patch_size=c["patch"], embed_dim=c["vit_dim"],
                 depth=c["vit_depth"], num_heads=c["vit_heads"], mlp_ratio=c["vit_mlp"],
                 proj_dim=c["emb"]),
        text=dict(vocab_size=c["txt_vocab"], max_length=c["txt_max_pos"], embed_dim=c["txt_dim"],
                  depth=c["txt_depth"], num_heads=c["txt_heads"]),
        dna=dict(vocab_size=c["dna_vocab"], projection_dim=c["emb"], embed_dim=c["dna_dim"],
                 depth=c["dna_depth"], num_heads=c["dna_heads"], max_length=c["dna_max_pos"]),
        total_steps=c["steps"], device="cpu")
    task.init_overlay, _ = import_lightning_checkpoint(
        str(inputs["init_ckpt"]), num_heads={"rgb": c["vit_heads"], "text": c["txt_heads"],
                                             "dna": c["dna_heads"]})
    imgs, txt, dna, ex_ids = (inputs[k] for k in ("imgs", "txt", "dna", "ex_ids"))
    batches = [{"rgb": np.transpose(imgs[i], (0, 2, 3, 1)), "text": txt[i].astype(np.int32),
                "dna": dna[i].astype(np.int32),
                "example_ids": {m: ex_ids for m in ("rgb", "text", "dna")}}
               for i in range(c["n_batches"])]
    losses, lrs, scales = [], [], []

    class Recorder(base.Capture):
        def on_train_batch_end(self, trainer, metrics, step):
            if "loss" in metrics:
                losses.append(float(metrics["loss"]))
                lrs.append(float(metrics["lr"]))
                scales.append(float(metrics["logit_scale"]))

    trainer = Trainer(max_steps=c["steps"], log_every_n_steps=1, mesh_shape=BIOSCAN_MESH,
                      callbacks=[LearningRateMonitor(), Recorder()], device="cpu",
                      default_root_dir=os.path.join(outdir, f"bioscan_root_{rank}"))
    trainer.fit(task, batches)
    out[f"bioscan_losses_{rank}"] = np.asarray(losses)
    out[f"bioscan_lrs_{rank}"] = np.asarray(lrs)
    out[f"bioscan_scales_{rank}"] = np.asarray(scales)
    set_global_mesh(None)


def scenario_ckpt(rank, outdir):
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh
    from mmlearn_tpu_torch.trainer import ModelCheckpoint

    ckpt = ModelCheckpoint(dirpath=os.path.join(outdir, "ckpt"), save_last=True,
                           async_save=False)
    base.fit(FIT_MESH, steps=2, callbacks=[ckpt],
             root=os.path.join(outdir, f"ckpt_root_{rank}"))
    set_global_mesh(None)


def scenario_eval(rank, outdir, out):
    """``tests/torch_mp_worker.py``'s evaluation scenario on a ``model``
    axis: the trainer (and so the mesh) first, then the sampler, which takes
    the mesh's batch shards."""
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

    trainer = Trainer(mesh_shape={"data": 2, "model": 2}, device="cpu", seed=0,
                      default_root_dir=os.path.join(outdir, f"eval_root_{rank}"))
    task = base.sgd_task()
    task.evaluation_tasks = {
        "retrieval": EvaluationSpec(task=ZeroShotCrossModalRetrieval(
            [RetrievalTaskSpec(query_modality="rgb", target_modality="text", top_k=[1, 5])])),
        "export": EvaluationSpec(task=EmbeddingExport(
            output_dir=os.path.join(outdir, "index"), modalities=["rgb"], shard_size=8)),
    }
    task.compute_validation_loss = True
    ds = CombinedDataset([SyntheticImageText(size=53, image_size=32, seq_len=16,
                                             vocab_size=64, num_classes=4)])
    sampler = DistributedEvalSampler(ds)
    out[f"eval_sampler_{rank}"] = np.asarray([sampler.rank, sampler.num_replicas])
    loader = DataLoader(ds, batch_size=8, sampler=sampler, pad_partial_batches=True)
    trainer.prepare_eval_state(task, loader)
    for key, value in trainer.validate(task, loader).items():
        out[f"eval/{key}_{rank}"] = np.asarray(value)

    rng = np.random.default_rng(5)
    scores = rng.standard_normal((53, 4)).astype(np.float32)
    targets = rng.integers(0, 4, 53)
    mine = np.arange(trainer.mesh.dp_rank, 53, trainer.mesh.dp_size)
    hook = ZeroShotClassification.__new__(ZeroShotClassification)
    hook.task_specs = []
    hook._class_embeddings = {}
    hook._scores = {("rgb", 0): [(torch.tensor(scores[mine]), torch.tensor(targets[mine]),
                                  torch.ones(len(mine), dtype=torch.bool))]}
    for key, value in hook.on_evaluation_epoch_end(None).items():
        out[f"cls/{key}_{rank}"] = np.asarray(value)
    set_global_mesh(None)


def scenario_bridge(rank, out):
    """The tiny pair's seed-0 weights (JAX layout) loaded into a seed-1 task
    split and sharded at ``fsdp=2, model=2``, then gathered back."""
    from mmlearn_tpu_torch import bridge
    from mmlearn_tpu_torch.flagship import tiny_training_task
    from mmlearn_tpu_torch.parallel.mesh import create_mesh, set_global_mesh
    from mmlearn_tpu_torch.parallel.partitioning import shard_task

    want = bridge.torch_to_jax(tiny_training_task(seed=0))
    task = tiny_training_task(seed=1)
    mesh = create_mesh(**FIT_MESH, device="cpu")
    set_global_mesh(mesh)
    shard_task(task, mesh)
    bridge.load_state(task, bridge.jax_to_torch(want))
    got = bridge.torch_to_jax(task)
    out[f"bridge_keys_equal_{rank}"] = np.asarray(set(got) == set(want))
    out[f"bridge_max_diff_{rank}"] = np.asarray(max(
        float(np.abs(got[k] - want[k]).max()) for k in want))
    set_global_mesh(None)


def main() -> None:
    from mmlearn_tpu_torch.parallel.mesh import init_from_env

    outdir = sys.argv[1]
    torch.set_num_threads(1)
    init_from_env("cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 4, world
    out: dict[str, np.ndarray] = {}
    scenario_attention(rank, out)
    scenario_fit(rank, outdir, out)
    scenario_bioscan(rank, outdir, out)
    scenario_ijepa(rank, outdir, out)
    scenario_ckpt(rank, outdir)
    scenario_eval(rank, outdir, out)
    scenario_bridge(rank, out)
    from mmlearn_tpu_torch.flagship import dryrun_step

    out[f"dryrun_loss_{rank}"] = np.asarray(dryrun_step())
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"torch_tp_worker rank {rank}/{world} OK", flush=True)


if __name__ == "__main__":
    main()
