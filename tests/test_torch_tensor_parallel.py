"""The port's tensor parallelism (the mesh's ``model`` axis) on the CPU,
against the JAX package on its 8 virtual devices.

In this process: every parameter's spec, and the column and row splits
that apply its ``model`` entry, against JAX ``infer_param_specs`` for the
tiny flagship pair, the tiny I-JEPA task and the BIOSCAN-CLIP towers, on
``data=2, fsdp=2, model=2`` and ``data=4, model=2`` (and the BIOSCAN
towers' scanned kernels, the counterpart of
``tests/modules/test_scan_blocks.py``); ``shard_plan`` against JAX
``_shard_map_plan`` on a grid of meshes, head counts, head dims and batches.

One module-scoped spawn of 4 gloo processes (``tests/torch_tp_worker.py``
through ``parallel/mp_launch.py``) runs every multi-process scenario while
this process computes the references:

- the attention layer at ``data=2, model=2`` against JAX ``fused_mha`` on
  ``create_mesh(data=4, model=2)``: output, ``proj``'s input and the qkv
  gradient at atol 1e-5 (``tests/ops/test_fused_attention_sharded.py``'s),
  with and without a key mask, on the fused route, the plain route of the
  ``"xla"`` plan (counted) and a split that is not on whole heads; a block
  with every dropout and drop-path against one process (masks drawn for the
  whole layer and sliced);
- a clipped fit of the tiny pair at ``fsdp=2, model=2`` against one process
  (losses and ``grad_norm`` rtol 2e-5 / atol 1e-6, weights 1e-5 / 1e-6,
  ``tests/parallel/test_multiprocess.py``'s) and its losses against the JAX
  ``Trainer`` on ``data=2, fsdp=2, model=2`` at the one-device tolerance of
  ``tests/tasks/test_end_to_end.py`` (rtol 2e-3); every parameter's
  placement;
- ``data=1, seq=2, model=2`` against one process at rtol 5e-3
  (``test_end_to_end.py:195-235``);
- a tiny I-JEPA task at ``data=2, model=2`` against one process (the
  predictor split, the EMA teacher updated on its local shards);
- the BIOSCAN-CLIP fixture trajectory at ``data=2, model=2`` against
  ``reference_bioscan_trajectory`` (first loss 1e-5, losses 5e-3, rates
  1e-5: ``tests/tasks/test_bioscan_trajectory.py:411-456``);
- a checkpoint saved at ``fsdp=2, model=2`` resumed in one process
  (1e-5 / 1e-6); the recall, classification and exports at ``data=2,
  model=2`` equal to one process with no row written twice; the dry run's
  step at ``fsdp=2, model=2`` against one process; a whole state dict
  loaded into a parallelized task and gathered back, bit-equal.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.ops.fused_attention import _shard_map_plan
from mmlearn_tpu.ops.fused_attention import fused_mha as jax_fused_mha
from mmlearn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from mmlearn_tpu.parallel.mesh import set_global_mesh as jax_set_global_mesh
from mmlearn_tpu.parallel.partitioning import infer_param_specs as jax_infer_param_specs
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.flagship import tiny_training_task
from mmlearn_tpu_torch.modules.encoders import VisionTransformer, VisionTransformerPredictor
from mmlearn_tpu_torch.modules.layers.attention import kernel_route
from mmlearn_tpu_torch.ops.fused_attention import shard_plan
from mmlearn_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, mesh_shape
from mmlearn_tpu_torch.parallel.mp_launch import run_workers
from mmlearn_tpu_torch.parallel.partitioning import _layouts, infer_param_specs, shard_dim
from mmlearn_tpu_torch.parallel.tensor_parallel import COLUMN, ROW, tp_plan
from mmlearn_tpu_torch.tasks import IJEPA
from tests.tasks.test_bioscan_trajectory import (
    BIOSCAN_TRAJ,
    FIXTURE,
    INIT_CKPT,
    make_bioscan_trajectory_data,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_mp_worker as base  # noqa: E402
import torch_tp_worker as worker  # noqa: E402
from test_torch_bioscan import fixture_task  # noqa: E402
from test_torch_parallel import single_eval  # noqa: E402

WORLD = 4
MESHES = [dict(data=2, fsdp=2, model=2), dict(data=4, model=2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models on one intra-op thread (several test workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------- specs and the splits


def tiny_ijepa():
    return IJEPA(VisionTransformer(img_size=64, patch_size=16, embed_dim=32, depth=2,
                                   num_heads=4),
                 VisionTransformerPredictor(num_patches=16, embed_dim=32,
                                            predictor_embed_dim=16, depth=1, num_heads=4))


TASKS = {"flagship": tiny_training_task, "ijepa": tiny_ijepa, "bioscan": fixture_task}


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def jax_specs(flat: dict, mesh_kw: dict) -> dict[str, tuple]:
    """``{JAX path: spec}`` of the JAX ``infer_param_specs`` over a tree of
    these leaves."""
    specs = jax_infer_param_specs(_nested(flat), jax_create_mesh(**mesh_kw))
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        out["/".join(str(getattr(p, "key", p)) for p in path)] = tuple(spec)
    return out


@pytest.mark.parametrize("mesh_kw", MESHES, ids=["dfm", "dm"])
@pytest.mark.parametrize("name", sorted(TASKS))
def test_specs_and_splits_match_jax(name, mesh_kw):
    """Every parameter's spec (in the port's dims) is the JAX spec of its
    JAX path and layout, and the split that applies it puts ``model`` on
    that dim: column (the weight's output rows) where the JAX kernel's
    output dim names ``model``, row where its input dim does, nothing on
    the other parameters (biases, norms, embeddings, heads, LoRA factors,
    the logit scale); a qkv split hands ``proj`` its heads exactly where
    they divide over ``model``."""
    task = TASKS[name]()
    flat = bridge.torch_to_jax(task)
    want_specs = jax_specs(flat, mesh_kw)
    names, sizes = mesh_shape(8, **mesh_kw)
    specs = infer_param_specs(task, Mesh(names, sizes, "cpu"))
    paths = bridge.jax_paths(task)
    params = dict(task.named_parameters())
    assert set(specs) == set(params) and {paths[n] for n in specs} == set(want_specs)
    layouts = _layouts(task)
    for pname, spec in specs.items():
        want = want_specs[paths[pname]]
        axes = layouts[pname][1]
        if want and axes is not None:  # JAX dim i is the port's dim axes[i]
            mine = [None] * params[pname].ndim
            for i, axis in enumerate(want):
                mine[axes[i]] = axis
            want = tuple(mine)
        want = tuple(want) + (None,) * (params[pname].ndim - len(want)) if want else ()
        assert spec == want, (pname, spec, want)
    plan = tp_plan(task, specs, model=2)
    split = 0
    for pname, spec in specs.items():
        layer, _, leaf = pname.rpartition(".")
        if leaf == "weight" and layer in plan:
            kind, gathered = plan[layer]
            assert spec.index(MODEL_AXIS) == (0 if kind == COLUMN else 1), pname
            assert shard_dim(spec) != spec.index(MODEL_AXIS), pname
            split += 1
        else:
            assert MODEL_AXIS not in spec, pname
    assert split > 0
    modules = dict(task.named_modules())
    for layer, (kind, gathered) in plan.items():
        owner = modules[layer.rsplit(".", 1)[0]]
        if layer.endswith(".qkv"):
            assert gathered == (owner.num_heads % 2 != 0), layer
            assert plan[layer[:-len("qkv")] + "proj"] == (ROW, gathered)
    if name == "bioscan":
        # the scanned layout's 3-d kernels: (None, fsdp, model) / (None, model, fsdp)
        scanned = jax_specs(bridge.torch_to_jax(task, scanned=True), mesh_kw)
        checked = 0
        for path, spec in scanned.items():
            if "block_stack" in path and path.endswith(("qkv/kernel", "fc1/kernel")):
                assert spec == (None, "fsdp", "model"), path
                checked += 1
            elif "block_stack" in path and path.endswith(("proj/kernel", "fc2/kernel")):
                assert spec == (None, "model", "fsdp"), path
                checked += 1
        assert checked == 12  # 4 kernels x 3 towers


PLAN_MESHES = [dict(data=8), dict(data=4, fsdp=2), dict(data=4, model=2),
               dict(data=2, fsdp=2, model=2), dict(data=2, model=4), dict(data=1, model=8),
               dict(data=2, seq=2, model=2)]


@pytest.fixture
def jax_mesh_reset():
    yield
    jax_set_global_mesh(None)


@pytest.mark.parametrize("mesh_kw", PLAN_MESHES,
                         ids=["d8", "d4f2", "d4m2", "d2f2m2", "d2m4", "m8", "d2s2m2"])
def test_shard_plan_matches_jax(mesh_kw, jax_mesh_reset):
    """``shard_plan`` against ``_shard_map_plan`` over heads 1-16, head
    dims 16-128 and batches 1-16, outcome for outcome (the JAX plan's mesh
    and axes aside: the port's plan is the local head count), the ``"xla"``
    cases of ``tests/ops/test_fused_attention_sharded.py`` among them; no
    mesh and a one-device mesh plan nothing."""
    jax_set_global_mesh(jax_create_mesh(**mesh_kw))
    names, sizes = mesh_shape(8, **mesh_kw)
    mesh = Mesh(names, sizes, "cpu")
    outcomes = set()
    for heads in (1, 2, 3, 4, 6, 8, 12, 16):
        for d in (16, 32, 64, 80, 88, 128):
            for b in (1, 2, 4, 8, 12, 16):
                want = _shard_map_plan(heads, d, b)
                want = want[-1] if isinstance(want, tuple) else want
                assert shard_plan(heads, d, b, mesh) == want, (heads, d, b)
                outcomes.add("xla" if want == "xla" else "heads")
    assert "xla" in outcomes
    if "seq" not in mesh_kw:
        assert "heads" in outcomes
    if mesh_kw == dict(data=8):
        assert shard_plan(8, 64, 12, mesh) == "xla"  # 12 % 8
        assert shard_plan(8, 16, 12, mesh) == "xla"
    if mesh_kw == dict(data=1, model=8):
        assert shard_plan(8, 64, 16, mesh) == "xla"  # 1 local head, group of 2
    assert shard_plan(8, 64, 8, None) is None
    assert shard_plan(8, 64, 8, Mesh(*mesh_shape(1), "cpu")) is None


@pytest.mark.parametrize("heads,d,n,model,want", [
    (12, 64, 197, 4, "flash"),  # ViT-B/16 at model=4: 3 local heads, head group 2
    (16, 80, 257, 4, "flash"),  # ViT-H/14 at model=4: 4 local heads, head group 8
    (6, 64, 77, 4, "fused"),  # H % model != 0: qkv gathered, every head a rank
    (12, 64, 197, 2, "fused"),  # the flagship's image tower at model=2: 6 local heads
], ids=["b16m4", "h14m4", "gathered", "b16m2"])
def test_kernel_route_keeps_xla_plans_on_the_kernels(heads, d, n, model, want):
    """On the card a layer runs its local heads on K1 or K3 whatever the
    sharded plan says; only a CPU tensor takes the plain route where the
    plan is ``"xla"``, as the JAX package computes there, and under a
    ``seq`` axis it keeps K1's function."""
    mesh = Mesh(*mesh_shape(8, data=8 // model, model=model), "cpu")
    plan = shard_plan(heads, d, 8, mesh)
    assert (plan == "xla") == (want == "flash" or heads % model != 0)
    local = heads // model if heads % model == 0 else heads
    assert kernel_route("cuda", plan, 1, local, d, n) == want
    assert kernel_route("cpu", plan, 1, local, d, n) == ("plain" if plan == "xla" else "fused")
    assert kernel_route("cpu", "xla", 2, local, d, n) == "fused"


# --------------------------------------------- the 4-process spawn and refs


def _spawn(out, result: dict) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        run_workers([[sys.executable, os.path.join(HERE, "torch_tp_worker.py"), str(out)]]
                    * WORLD, env=env, cwd=REPO, timeout=300)
    except BaseException as err:  # noqa: BLE001 - raised in the test process below
        result["error"] = err


def jax_attention(case) -> dict[tuple[int, int, int], dict]:
    """JAX ``fused_mha`` under ``create_mesh(data=4, model=2)`` on the
    attention scenario's inputs: ``proj``'s input, the layer's output and
    the qkv gradient for the scenario's cotangent."""
    heads, d = case
    inp = worker.attn_inputs(heads, d)
    out = {}
    jax_set_global_mesh(jax_create_mesh(data=4, model=2))
    try:
        x = jnp.asarray(inp["x"])
        qkv = x @ inp["qkv_kernel"] + inp["qkv_bias"]
        for masked in (False, True):
            mask = jnp.asarray(inp["mask"]) if masked else None
            core, vjp = jax.vjp(jax.jit(lambda q, m=mask: jax_fused_mha(q, m, num_heads=heads)),
                                qkv)
            (dqkv,) = vjp(jnp.asarray(inp["g"]))
            y = core @ inp["proj_kernel"] + inp["proj_bias"]
            out[masked] = {"core": np.asarray(core), "dqkv": np.asarray(dqkv), "y": np.asarray(y)}
    finally:
        jax_set_global_mesh(None)
    return out


def jax_mesh_fit() -> np.ndarray:
    """The tiny pair's 6 clipped SGD steps in the JAX ``Trainer`` on
    ``data=2, fsdp=2, model=2`` from the port's initial weights."""
    from mmlearn_tpu.modules.encoders import TextTransformer as JText
    from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
    from mmlearn_tpu.tasks import ContrastivePretraining as JTask
    from mmlearn_tpu.trainer import Trainer as JTrainer

    jtask = JTask(
        encoders={"rgb": JVision(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                                 use_cls_token=True, global_pool="cls", proj_dim=32),
                  "text": JText(vocab_size=64, max_length=16, embed_dim=64, depth=2,
                                num_heads=4, pooling="eos", proj_dim=32)},
        optimizer=functools.partial(optax.sgd, learning_rate=0.1, momentum=0.9))
    task = base.sgd_task()
    scalars = {path for name, path in bridge.jax_paths(task).items()
               if task.get_parameter(name).ndim == 0}
    jtask.init_overlay = _nested({k: v.reshape(()) if k in scalars else v
                                  for k, v in bridge.torch_to_jax(task).items()})
    capture = base.Capture()
    trainer = JTrainer(max_steps=base.STEPS, log_every_n_steps=1, callbacks=[capture],
                       mesh_shape={"data": 2, "fsdp": 2, "model": 2}, seed=0,
                       gradient_clip_val=base.CLIP,
                       default_root_dir="/tmp/mmlearn_tp_jax_fit")
    trainer.fit(jtask, base.Loader(base.batches()))
    jax_set_global_mesh(None)
    return np.asarray(capture.losses)


def one_process_dryrun() -> float:
    """The dry run's step in one process on its global batch (the 4
    processes' 2 batch shards of 2 rows)."""
    from mmlearn_tpu_torch.datasets.builtin.synthetic import SyntheticImageText
    from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader
    from mmlearn_tpu_torch.datasets.core.samplers import CombinedDatasetRatioSampler
    from mmlearn_tpu_torch.trainer import Trainer

    ds = CombinedDataset([SyntheticImageText(size=2 * WORLD, image_size=32, seq_len=16,
                                             vocab_size=64, num_classes=4)])
    loader = DataLoader(ds, batch_size=4, sampler=CombinedDatasetRatioSampler(
        ds, shuffle=True, seed=0, rank=0, num_replicas=1), drop_last=True)
    capture = base.Capture()
    Trainer(max_steps=1, log_every_n_steps=1, callbacks=[capture], device="cpu").fit(
        tiny_training_task(), loader)
    return capture.losses[-1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 processes' results and directory, and the references computed
    here while they run."""
    out = tmp_path_factory.mktemp("four_processes")
    imgs, txt, dna, ex_ids = make_bioscan_trajectory_data()
    np.savez(out / "bioscan_inputs.npz", imgs=imgs, txt=txt, dna=dna, ex_ids=ex_ids,
             config=json.dumps(BIOSCAN_TRAJ), init_ckpt=INIT_CKPT)
    result: dict = {}
    spawn = threading.Thread(target=_spawn, args=(out, result))
    spawn.start()
    refs: dict = {}
    try:
        task, capture = base.fit(None, root=str(tmp_path_factory.mktemp("one_fit")))
        refs["fit"] = (np.asarray(capture.losses), np.asarray(capture.grad_norms),
                       base.flat_params(task))
        refs["attn"] = {case: jax_attention(case) for case in worker.ATTN_CASES}
        refs["block"] = worker.dropout_block(None)
        refs["eval"] = single_eval(tmp_path_factory.mktemp("one_eval"))
        refs["dryrun"] = one_process_dryrun()
        refs["ijepa"] = worker.ijepa_fit(None, str(tmp_path_factory.mktemp("one_ijepa")))
        refs["jax_fit"] = jax_mesh_fit()
    finally:
        spawn.join(timeout=330)
    assert not spawn.is_alive(), "the 4-process spawn did not end"
    if "error" in result:
        raise result["error"]
    return [np.load(out / f"rank{r}.npz") for r in range(WORLD)], out, refs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def refs(runs):
    return runs[2]


def _dp(r: int) -> int:
    return r // 2  # data=2, model=2: the model axis varies fastest


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("case", worker.ATTN_CASES, ids=["h4d64", "h2d64", "h3d32"])
def test_attention_matches_jax_fused_mha(ranks, refs, case, masked):
    """Each rank's output (``proj``'s row split: partial products reduced,
    the bias once), ``proj``'s input (its heads) and the gradient of
    ``qkv``'s output (its heads' columns) against JAX ``fused_mha`` on a
    ``model=2`` mesh, atol 1e-5. 4 heads run the fused route on 2 heads a
    rank; 2 heads take the plain route (``"xla"``: 1 local head does not
    tile D=64's head group of 2), counted; 3 heads gather ``qkv`` and run
    every head. ``MMLEARN_QUANT`` raises on the split layers."""
    heads, d = case
    want = refs["attn"][case][masked]
    c = heads * d
    tag = f"attn_{heads}_{d}_{int(masked)}"
    for r in range(WORLD):
        rows = slice(_dp(r) * 2, _dp(r) * 2 + 2)
        m = r % 2
        core, dqkv = want["core"][rows], want["dqkv"][rows]
        if heads % 2 == 0:
            core = core[..., m * c // 2:(m + 1) * c // 2]
            dqkv = dqkv[..., m * 3 * c // 2:(m + 1) * 3 * c // 2]
        np.testing.assert_allclose(ranks[r][f"{tag}_core_{r}"], core, atol=1e-5)
        np.testing.assert_allclose(ranks[r][f"{tag}_dqkv_{r}"], dqkv, atol=1e-5)
        np.testing.assert_allclose(ranks[r][f"{tag}_y_{r}"], want["y"][rows], atol=1e-5)
        assert int(ranks[r][f"{tag}_plain_{r}"]) == (1 if case == (2, 64) else 0)
        assert "model axis" in str(ranks[r][f"attn_{heads}_{d}_quant_raised_{r}"])


@pytest.mark.parametrize("case", worker.ATTN_CASES, ids=["h4d64", "h2d64", "h3d32"])
def test_returned_attention_weights_hold_every_head(ranks, case):
    """``return_weights`` at ``data=2, model=2``: the materialized route on
    the rank's heads, the weights gathered back to every head, equal to the
    layer's in one process (atol 1e-6)."""
    from mmlearn_tpu_torch.modules.layers.attention import Attention

    heads, d = case
    inp = worker.attn_inputs(heads, d)
    attn = Attention(heads * d, heads, qkv_bias=True)
    attn.load_state_dict({"qkv.weight": torch.tensor(inp["qkv_kernel"].T),
                          "qkv.bias": torch.tensor(inp["qkv_bias"]),
                          "proj.weight": torch.tensor(inp["proj_kernel"].T),
                          "proj.bias": torch.tensor(inp["proj_bias"])})
    with torch.no_grad():
        _, want = attn(torch.tensor(inp["x"]), return_weights=True)
    for r in range(WORLD):
        rows = slice(_dp(r) * 2, _dp(r) * 2 + 2)
        np.testing.assert_allclose(ranks[r][f"attn_{heads}_{d}_weights_{r}"],
                                   want[rows].numpy(), atol=1e-6)


def test_flop_counter_counts_a_rank_its_share(ranks):
    """``FlopCounter`` counts a split product at its local shapes: an MLP
    64 -> 256 -> 64 on 8 rows is 2 * 8 * (64 * 128 + 128 * 64) FLOPs a rank
    at ``model=2``, half the whole layer's (the MFU a rank over the peak of
    the mesh, the JAX trainer's per-device count)."""
    for r in range(WORLD):
        assert int(ranks[r][f"mlp_flops_{r}"]) == 2 * 8 * (64 * 128 + 128 * 64)


def test_dropout_masks_are_sliced_from_the_whole_draw(ranks, refs):
    """A block with attention dropout, dropout and drop-path, split at
    ``model=2``, each rank on the whole batch: the output and the input's
    gradient equal one process's (atol 1e-5): the masks on split dims
    (heads, hidden columns) are the whole layer's draw cut to the rank's."""
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"block_y_{r}"], refs["block"]["y"], atol=1e-5)
        np.testing.assert_allclose(ranks[r][f"block_dx_{r}"], refs["block"]["dx"], atol=1e-5)


def test_fit_matches_one_process_and_the_jax_mesh(ranks, refs):
    """6 steps of the tiny pair clipped at 1.0 (steps 1-3 clipped) at
    ``fsdp=2, model=2``: each step's loss and ``grad_norm`` (each element
    counted once: the split weights' squares summed over ``fsdp`` and
    ``model``, the replicated ones once) and the weights against one
    process; the losses against the JAX ``Trainer`` on ``data=2, fsdp=2,
    model=2`` at its one-device tolerance."""
    losses, grad_norms, params = refs["fit"]
    assert grad_norms[0] > base.CLIP
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"fit_losses_{r}"], losses, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(ranks[r][f"fit_grad_norms_{r}"], grad_norms, rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(ranks[r][f"fit_params_{r}"], ranks[0]["fit_params_0"])
        np.testing.assert_allclose(ranks[r][f"fit_losses_{r}"], refs["jax_fit"], rtol=2e-3)
    np.testing.assert_allclose(ranks[0]["fit_params_0"], params, rtol=1e-5, atol=1e-6)


def test_placements_are_the_specs(runs):
    """Every parameter of the fit's task as the ranks hold it: over
    ``model`` sharded on its spec's ``model`` dim (else replicated), over
    ``fsdp`` on its spec's ``fsdp`` dim (dim 0 where it names none),
    replicated over ``data``; the 0-d logit scale plain."""
    _, out, _ = runs
    with open(out / "placements.json") as f:
        got = json.load(f)
    task = tiny_training_task()
    names, sizes = mesh_shape(WORLD, **worker.FIT_MESH)
    specs = infer_param_specs(task, Mesh(names, sizes, "cpu"))
    assert set(got) == set(specs)
    for name, spec in specs.items():
        if task.get_parameter(name).ndim == 0:
            assert got[name] == {}
            continue
        want = {"data": "R", "fsdp": f"S({shard_dim(spec)})"}
        if MODEL_AXIS in spec:
            want["model"] = f"S({spec.index(MODEL_AXIS)})"
        elif "model" in got[name]:
            want["model"] = "R"
        assert got[name] == want, name


def test_seq_and_model_fit_matches_one_process(ranks, refs):
    """``data=1, seq=2, model=2``: the text tower's attention goes round the
    ring on each rank's heads; the 3 steps' losses and gradient norms
    against one process at ``test_end_to_end.py``'s rtol 5e-3 (its 3-step
    fit on that mesh)."""
    losses, grad_norms, _ = refs["fit"]
    n = worker.SEQ_STEPS
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"seq_losses_{r}"], losses[:n], rtol=5e-3)
        np.testing.assert_allclose(ranks[r][f"seq_grad_norms_{r}"], grad_norms[:n], rtol=5e-3)


def test_bioscan_trajectory_at_model_2(ranks):
    """The BIOSCAN-CLIP fixture trajectory (LoRA merged into each rank's
    share of the split weights, the one-cycle schedule) at ``data=2,
    model=2``: first loss 1e-5, losses 5e-3, rates 1e-5, as the JAX
    8-device test."""
    fx = np.load(FIXTURE)
    for r in range(WORLD):
        losses = ranks[r][f"bioscan_losses_{r}"]
        assert len(losses) == BIOSCAN_TRAJ["steps"]
        np.testing.assert_allclose(losses[0], fx["losses"][0], rtol=1e-5)
        np.testing.assert_allclose(losses, fx["losses"], rtol=5e-3)
        np.testing.assert_allclose(ranks[r][f"bioscan_lrs_{r}"], fx["lrs"], rtol=1e-5)


def test_ijepa_at_model_2_matches_one_process(ranks, refs):
    """A tiny I-JEPA task at ``data=2, model=2``: the predictor split as a
    tower, the EMA teacher sharded as its student (its update elementwise
    on the local shards): the losses (rtol 2e-5, atol 1e-6) and every
    parameter, the teacher's included (1e-5 / 1e-6), against one process."""
    losses, params = refs["ijepa"]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"ijepa_losses_{r}"], losses, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(ranks[r][f"ijepa_params_{r}"], params, rtol=1e-5, atol=1e-6)


def test_checkpoint_from_a_model_mesh_resumes_in_one_process(runs, tmp_path):
    """2 steps at ``fsdp=2, model=2`` written by rank 0 in the one-device
    format (weights and moments gathered over ``fsdp`` and ``model``),
    resumed in one process to step 4: an uninterrupted 4-step fit's weights
    (rtol 1e-5, atol 1e-6)."""
    from mmlearn_tpu_torch.trainer import Trainer

    _, out, _ = runs
    resumed = base.sgd_task()
    trainer = Trainer(max_steps=4, log_every_n_steps=1, device="cpu", seed=0,
                      default_root_dir=str(tmp_path / "a"), gradient_clip_val=base.CLIP)
    state = trainer.fit(resumed, base.Loader(base.batches()), ckpt_path=str(out / "ckpt"))
    assert trainer.restored_step == 2 and state.step == 4
    straight, _ = base.fit(None, steps=4, root=str(tmp_path / "b"))
    np.testing.assert_allclose(base.flat_params(resumed), base.flat_params(straight),
                               rtol=1e-5, atol=1e-6)


def test_eval_and_exports_count_each_row_once(runs, refs):
    """At ``data=2, model=2`` the eval sampler takes the mesh's 2 batch
    shards; recall@1/5, the classification metrics and the validation loss
    equal one process's (abs 1e-9); one rank of each ``model`` group writes
    its shard's export: 2 manifests, 27 + 26 rows covering the 53 examples
    once, each row the one-process export's (rtol 1e-5)."""
    from mmlearn_tpu_torch.serving.index import EmbeddingIndex

    ranks, out, _ = runs
    results, single = refs["eval"]
    for r in range(WORLD):
        assert ranks[r][f"eval_sampler_{r}"].tolist() == [_dp(r), 2]
        for key in ("retrieval/rgb_to_text_R@1", "retrieval/rgb_to_text_R@5"):
            assert float(ranks[r][f"eval/{key}_{r}"]) == pytest.approx(results[key], abs=1e-9)
        for key in ("classification/ds0_rgb_top1_accuracy", "classification/ds0_rgb_f1",
                    "classification/ds0_rgb_auroc"):
            assert float(ranks[r][f"cls/{key}_{r}"]) == pytest.approx(results[key], abs=1e-9)
    index_dir = out / "index"
    manifests = sorted(f for f in os.listdir(index_dir) if f.startswith("manifest"))
    assert manifests == ["manifest_p0.json", "manifest_p1.json"]
    assert sorted(json.load(open(index_dir / m))["rgb"]["rows"] for m in manifests) == [26, 27]
    index = EmbeddingIndex.load(str(index_dir), "rgb", device="cpu")
    want = EmbeddingIndex.load(str(single / "index"), "rgb", device="cpu")
    assert sorted(np.asarray(index.example_index).tolist()) == list(range(53))
    order = np.argsort(np.asarray(index.example_index))
    np.testing.assert_allclose(np.asarray(index.embeddings)[order],
                               np.asarray(want.embeddings)[np.argsort(want.example_index)],
                               rtol=1e-5, atol=1e-6)


def test_dryrun_step_on_a_model_mesh(ranks, refs):
    """``dryrun_multichip(4)``'s step (mesh ``fsdp=2, model=2``, the JAX dry
    run's rule): the same loss on the 4 processes, one process's on the
    global batch (rtol 1e-5)."""
    losses = [float(ranks[r][f"dryrun_loss_{r}"]) for r in range(WORLD)]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], refs["dryrun"], rtol=1e-5)


def test_bridge_loads_and_gathers_a_parallelized_task(ranks):
    """The tiny pair's JAX-layout weights loaded into a task split and
    sharded at ``fsdp=2, model=2`` (``set_model_state_dict``, full), then
    gathered back by ``torch_to_jax``: the same paths and bits."""
    for r in range(WORLD):
        assert bool(ranks[r][f"bridge_keys_equal_{r}"])
        assert float(ranks[r][f"bridge_max_diff_{r}"]) == 0.0
