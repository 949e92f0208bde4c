"""The port's parallelism (``mmlearn_tpu_torch.parallel``) on the CPU: the
mesh and the partitioning rules against the JAX package's on its 8 virtual
devices, the collectives on a one-process gloo group, and one spawn of 2
gloo processes (``tests/torch_mp_worker.py``, through the port's
``mp_launch``) that runs every multi-process scenario, each held to one
process on the global batch at the tolerances of
``tests/parallel/test_multiprocess.py``: the fit at ``data=2`` and at
``fsdp=2`` (losses and gradient norms rtol 2e-5 / atol 1e-6, weights 1e-5 /
1e-6; SGD, whose update is linear in the gradient, clipped by the global
norm), the contrastive loss's gradients through
the gather, the retrieval recall and the classification metrics (equal), the
export shards, a checkpoint saved at world 2 and resumed at world 1 (1e-5 /
1e-6), the ring over ``batch_isend_irecv`` (bit-equal to the list exchange)
and the attention layer on a ``seq`` group.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from mmlearn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from mmlearn_tpu.parallel.partitioning import infer_param_specs as jax_infer_param_specs
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.flagship import tiny_training_task
from mmlearn_tpu_torch.parallel import collectives as col
from mmlearn_tpu_torch.parallel.mesh import MESH_AXES, Mesh, create_mesh, mesh_shape
from mmlearn_tpu_torch.parallel.mp_launch import free_port, run_workers
from mmlearn_tpu_torch.parallel.partitioning import infer_param_specs

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_mp_worker as worker  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models on one intra-op thread: under a parallel test run,
    several workers' thread pools on the same cores slow them many times
    over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ the mesh


@pytest.mark.parametrize("kw", [dict(data=8), dict(data=-1, fsdp=2), dict(data=2, fsdp=2, seq=2),
                                dict(data=-1, seq=4), dict(data=1, fsdp=1, seq=8),
                                dict(data=4, fsdp=2, slices=2), dict(data=2, fsdp=2, model=2),
                                dict(data=-1, model=4), dict(data=2, seq=2, model=2)])
def test_mesh_shape_matches_jax(kw):
    """Axis names and sizes of ``create_mesh`` over 8 devices, as the JAX
    function lays them out."""
    jmesh = jax_create_mesh(**kw)
    names, sizes = mesh_shape(8, **kw)
    assert names == tuple(jmesh.axis_names)
    assert dict(zip(names, sizes)) == dict(jmesh.shape)


@pytest.mark.parametrize("kw,match", [(dict(fsdp=3), "not divisible"),
                                      (dict(data=4, fsdp=4), "needs more than"),
                                      (dict(data=6, slices=4), "divisible by slices")])
def test_mesh_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jax_create_mesh(**kw)
    with pytest.raises(ValueError, match=match):
        mesh_shape(8, **kw)


def test_mesh_of_one_process_and_the_model_axis():
    """Without a process group the mesh is one device of the JAX axes; a
    mesh larger than the processes raises; ``model > 1`` is accepted and
    meets the same check (its layout is held to the JAX mesh by
    ``test_mesh_shape_matches_jax``, its use by
    ``tests/test_torch_tensor_parallel.py``)."""
    mesh = create_mesh(device="cpu")
    assert mesh.axis_names == MESH_AXES and mesh.size == 1 and mesh.device_mesh is None
    assert mesh.model_size == 1 and mesh.model_rank == 0
    with pytest.raises(ValueError, match="needs more than"):
        create_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="needs more than"):
        create_mesh(data=1, model=2, device="cpu")


@pytest.mark.parametrize("shape", [dict(data=4, fsdp=2), dict(data=8)])
def test_param_specs_match_jax(shape):
    """Every parameter of the tiny flagship pair (``_flagship_task(tiny=
    True)``'s widths): the port's spec (in the port's dims) is the JAX
    ``infer_param_specs`` spec of its JAX path and layout, carried through
    the bridge (a Dense kernel is the transposed weight)."""
    task = tiny_training_task()
    # the JAX task's tree, as the bridge writes it: JAX paths and layouts
    # (tests/test_torch_encoders.py holds the bridge to the JAX task's own)
    jparams: dict = {}
    for path, arr in bridge.torch_to_jax(task).items():
        *heads, leaf = path.split("/")
        node = jparams
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = arr
    jspecs = jax_infer_param_specs(jparams, jax_create_mesh(**shape))
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        flat["/".join(str(getattr(p, "key", p)) for p in path)] = tuple(spec)
    names, sizes = mesh_shape(8, **shape)
    mine = infer_param_specs(task, Mesh(names, sizes, "cpu"))
    paths = bridge.jax_paths(task)
    params = dict(task.named_parameters())
    assert set(mine) == set(params)
    assert {paths[n] for n in mine} == set(flat)
    sharded = 0
    for name, spec in mine.items():
        want = flat[paths[name]]
        if params[name].ndim == 2 and want and paths[name].endswith("kernel"):
            want = want[::-1] if len(want) == 2 else (want + (None,))[::-1]
        want = tuple(want) + (None,) * (params[name].ndim - len(want)) if want else ()
        assert spec == want, (name, spec, want)
        sharded += "fsdp" in spec
    assert sharded > 0  # the rules name fsdp whatever its size


# ------------------------------------------------------------- collectives


@pytest.fixture
def gloo_world_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_at_world_one(gloo_world_one):
    """Each collective over a one-process gloo group is the identity of the
    JAX function over one device."""
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    g = col.all_gather(x)
    g.sum().backward()
    assert torch.equal(g, x) and torch.equal(x.grad, torch.ones(3, 2))
    assert torch.equal(col.all_gather(x, with_grad=False), x)
    assert col.all_gather(x, tiled=False).shape == (1, 3, 2)
    assert torch.equal(col.psum(x), x) and torch.equal(col.pmean(x), x)
    assert col.axis_index() == 0 and col.axis_size() == 1
    assert col.local_loss_label_offset("batch", 3) == 0
    assert torch.equal(col.process_allgather(x.detach()), x.detach())
    assert np.array_equal(col.process_allgather(np.arange(4)), np.arange(4))
    assert col.process_allgather_object({"a": 1}) == [{"a": 1}]
    assert np.array_equal(col.process_local_rows(x), x.detach().numpy())


# ------------------------------------------------- the 2-process scenarios


def single_eval(out):
    """Validation with retrieval and an export over the 53 examples in one
    process, and the classification metrics over all the scores."""
    from mmlearn_tpu_torch.datasets.builtin.synthetic import SyntheticImageText
    from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader
    from mmlearn_tpu_torch.tasks.contrastive_pretraining import EvaluationSpec
    from mmlearn_tpu_torch.tasks.embedding_export import EmbeddingExport
    from mmlearn_tpu_torch.tasks.zero_shot_classification import ZeroShotClassification
    from mmlearn_tpu_torch.tasks.zero_shot_retrieval import (
        RetrievalTaskSpec,
        ZeroShotCrossModalRetrieval,
    )
    from mmlearn_tpu_torch.trainer import Trainer

    task = worker.sgd_task()
    task.evaluation_tasks = {
        "retrieval": EvaluationSpec(task=ZeroShotCrossModalRetrieval(
            [RetrievalTaskSpec(query_modality="rgb", target_modality="text", top_k=[1, 5])])),
        "export": EvaluationSpec(task=EmbeddingExport(
            output_dir=str(out / "index"), modalities=["rgb"], shard_size=8)),
    }
    ds = CombinedDataset([SyntheticImageText(size=53, image_size=32, seq_len=16,
                                             vocab_size=64, num_classes=4)])
    loader = DataLoader(ds, batch_size=8, pad_partial_batches=True)
    trainer = Trainer(device="cpu", seed=0, default_root_dir=str(out / "root"))
    trainer.prepare_eval_state(task, loader)
    results = trainer.validate(task, loader)
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((53, 4)).astype(np.float32)
    targets = rng.integers(0, 4, 53)
    hook = ZeroShotClassification.__new__(ZeroShotClassification)
    hook.task_specs, hook._class_embeddings = [], {}
    hook._scores = {("rgb", 0): [(torch.tensor(scores), torch.tensor(targets),
                                  torch.ones(53, dtype=torch.bool))]}
    results.update(hook.on_evaluation_epoch_end(None))
    return results, out


def _spawn(out, result: dict) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        run_workers([[sys.executable, os.path.join(HERE, "torch_mp_worker.py"), str(out)]] * 2,
                    env=env, cwd=REPO, timeout=300)
    except BaseException as err:  # noqa: BLE001 - raised in the test process below
        result["error"] = err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 gloo processes running every scenario, and meanwhile,
    in this process, the same fit and evaluation on the global batch: the
    ranks' results, the spawn's directory, the one-process fit and eval."""
    out = tmp_path_factory.mktemp("two_processes")
    result: dict = {}
    spawn = threading.Thread(target=_spawn, args=(out, result))
    spawn.start()
    try:
        task, capture = worker.fit(None, root=str(tmp_path_factory.mktemp("one_process")))
        fit = (np.asarray(capture.losses), np.asarray(capture.grad_norms),
               worker.flat_params(task))
        evaluation = single_eval(tmp_path_factory.mktemp("one_process_eval"))
    finally:
        spawn.join(timeout=330)
    assert not spawn.is_alive(), "the 2-process spawn did not end"
    if "error" in result:
        raise result["error"]
    return [np.load(out / f"rank{r}.npz") for r in range(2)], out, fit, evaluation


@pytest.fixture(scope="module")
def two_processes(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def one_process(runs):
    return runs[2]


@pytest.fixture(scope="module")
def one_process_eval(runs):
    return runs[3]


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_fit_matches_one_process(two_processes, one_process, axis):
    """Every step's loss and gradient norm (the norm the clipping applies,
    which counts the replicated logit scale's gradient once) and the
    weights."""
    ranks, _ = two_processes
    losses, grad_norms, params = one_process
    assert grad_norms[0] > worker.CLIP  # the first steps are clipped
    for r in range(2):
        np.testing.assert_allclose(ranks[r][f"fit_{axis}_losses_{r}"], losses, rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ranks[r][f"fit_{axis}_grad_norms_{r}"], grad_norms,
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(ranks[0][f"fit_{axis}_params_0"],
                                  ranks[1][f"fit_{axis}_params_1"])
    np.testing.assert_allclose(ranks[0][f"fit_{axis}_params_0"], params, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local", [False, True])
def test_contrastive_gradients_through_the_gather(two_processes, local):
    """Each rank's embedding gradients are the world size times its rows of
    one process's gradients on the global batch (FSDP2 then averages the
    ranks); the global loss is every rank's (``local_loss``: their mean).
    Rounding of f32 sums taken in another order: rtol 1e-5, atol 1e-7."""
    from mmlearn_tpu_torch.modules.losses.contrastive import ContrastiveLoss, LossPairSpec

    ranks, _ = two_processes
    za, zb, presence = worker.loss_inputs()
    a, b = (torch.tensor(z, requires_grad=True) for z in (za, zb))
    want, _ = ContrastiveLoss(l2_normalize=True)(
        {"rgb": a, "text": b}, None, torch.tensor(10.0), [LossPairSpec(("rgb", "text"))],
        presence={"rgb": torch.tensor(presence), "text": torch.tensor(presence)})
    want.backward()
    tag = "local" if local else "global"
    got = [float(ranks[r][f"loss_{tag}_{r}"]) for r in range(2)]
    np.testing.assert_allclose(np.mean(got) if local else got, float(want), rtol=1e-6)
    half = worker.GLOBAL_BATCH // 2
    for r in range(2):
        for name, z in (("a", a), ("b", b)):
            np.testing.assert_allclose(ranks[r][f"grad_{name}_{tag}_{r}"] / 2,
                                       z.grad[r * half:(r + 1) * half].numpy(), rtol=1e-5,
                                       atol=1e-7)


def test_eval_metrics_match_one_process(two_processes, one_process_eval):
    """Recall@1/5 over shards of 27 and 26 gathered at the epoch's end, and
    the classification metrics over each rank's scores, equal one process's
    (abs 1e-9, as the JAX test); the validation loss is the mean over the
    batches of both ranks."""
    ranks, _ = two_processes
    results, _ = one_process_eval
    for key in ("retrieval/rgb_to_text_R@1", "retrieval/rgb_to_text_R@5",
                "classification/ds0_rgb_top1_accuracy", "classification/ds0_rgb_f1",
                "classification/ds0_rgb_auroc"):
        prefix = "eval" if key.startswith("retrieval") else "cls"
        for r in range(2):
            assert float(ranks[r][f"{prefix}/{key}"]) == pytest.approx(results[key], abs=1e-9)
    assert float(ranks[0]["eval/validation/loss"]) > 0


def test_export_shards_cover_the_corpus(two_processes, one_process_eval):
    """Each process writes its own shards and manifest (``_p{rank}``): 27
    and 26 rows, together every example once, each row the one-process
    export's (rtol 1e-5: the same tower on other batch rows)."""
    from mmlearn_tpu_torch.serving.index import EmbeddingIndex

    _, out = two_processes
    _, single = one_process_eval
    index_dir = out / "index"
    manifests = sorted(f for f in os.listdir(index_dir) if f.startswith("manifest"))
    assert manifests == ["manifest_p0.json", "manifest_p1.json"]
    rows = [json.load(open(index_dir / m))["rgb"]["rows"] for m in manifests]
    assert sorted(rows) == [26, 27]
    index = EmbeddingIndex.load(str(index_dir), "rgb", device="cpu")
    want = EmbeddingIndex.load(str(single / "index"), "rgb", device="cpu")
    assert sorted(np.asarray(index.example_index).tolist()) == list(range(53))
    order = np.argsort(np.asarray(index.example_index))
    want_order = np.argsort(np.asarray(want.example_index))
    np.testing.assert_allclose(np.asarray(index.embeddings)[order],
                               np.asarray(want.embeddings)[want_order], rtol=1e-5, atol=1e-6)


def test_checkpoint_from_two_processes_resumes_in_one(two_processes, tmp_path):
    """Two steps at ``fsdp=2`` saved in the one-device format by rank 0,
    resumed in one process to step 4: the weights of an uninterrupted
    4-step fit (rtol 1e-5, atol 1e-6)."""
    _, out = two_processes
    resumed = worker.sgd_task()
    from mmlearn_tpu_torch.trainer import Trainer

    trainer = Trainer(max_steps=4, log_every_n_steps=1, device="cpu", seed=0,
                      default_root_dir=str(tmp_path / "a"), gradient_clip_val=worker.CLIP)
    state = trainer.fit(resumed, worker.Loader(worker.batches()), ckpt_path=str(out / "ckpt"))
    assert trainer.restored_step == 2 and state.step == 4
    straight, _ = worker.fit(None, steps=4, root=str(tmp_path / "b"))
    np.testing.assert_allclose(worker.flat_params(resumed), worker.flat_params(straight),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_over_process_groups_is_bit_equal_to_the_list_exchange(two_processes, causal):
    """The ring at P=2 over ``batch_isend_irecv`` gives the same bits as the
    one-process list exchange: output and the three gradients; its hops are
    P per rank and pass (causal: the diagonal and the earlier ones)."""
    from mmlearn_tpu_torch.ops.ring_attention import ListExchange, ring_attention_blocks

    ranks, _ = two_processes
    q, k, v = worker.ring_inputs()
    n = q.shape[2] // 2
    blocks = [[torch.tensor(x[:, :, r * n:(r + 1) * n], requires_grad=True) for r in range(2)]
              for x in (q, k, v)]
    outs = ring_attention_blocks(*blocks, 16 ** -0.5, causal, ListExchange(2))
    sum((o * torch.cos(o)).sum() for o in outs).backward()
    for r in range(2):
        tag = f"ring_{int(causal)}_{r}"
        np.testing.assert_array_equal(ranks[r][f"{tag}_out"], outs[r].detach().numpy())
        for name, b in zip("qkv", blocks):
            np.testing.assert_array_equal(ranks[r][f"{tag}_d{name}"], b[r].grad.numpy())
    # per rank over both passes: non-causal 2 hops, causal rank r r + 1
    assert [ranks[r][f"ring_hops_{r}"].tolist() for r in range(2)] == [[3, 3, 2], [4, 4, 0]]


def test_seq_group_attention_matches_one_process(two_processes):
    """The attention layer on a ``seq`` group of 2 against no mesh: the
    output and the input's gradient (each rank holds the whole of both, the
    gather's backward returning its own block, not the group's sum), and the
    projection's weight gradient, whole on each rank (atol 2e-5, the JAX
    test's)."""
    from mmlearn_tpu_torch.modules.layers.attention import Attention

    ranks, _ = two_processes
    torch.manual_seed(0)
    attn = Attention(64, num_heads=4, qkv_bias=True)
    x = torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 64)).astype(np.float32),
                     requires_grad=True)
    y = attn(x)
    (y * y).sum().backward()
    for r in range(2):
        np.testing.assert_allclose(ranks[r][f"seq_out_{r}"], y.detach().numpy(), atol=2e-5)
        np.testing.assert_allclose(ranks[r][f"seq_dx_{r}"], x.grad.numpy(), atol=2e-5)
        np.testing.assert_allclose(ranks[r][f"seq_dw_{r}"], attn.qkv.weight.grad.numpy(),
                                   atol=2e-5)


def test_dryrun_step_two_processes(two_processes):
    """The flagship dry run's step (``dryrun_multichip``'s, in the spawn):
    one sharded step of the tiny pair over 2 CPU processes (``data=1,
    fsdp=2``), each loading its rows through the distributed sampler: the
    same finite loss on both."""
    ranks, _ = two_processes
    losses = [float(ranks[r][f"dryrun_loss_{r}"]) for r in range(2)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
