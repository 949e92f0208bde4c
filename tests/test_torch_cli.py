"""The port's experiment CLI (``mmlearn_tpu_torch.cli``) on the CPU
(``trainer.device=cpu``): a counterpart of each test of
``tests/test_cli_e2e.py`` and ``tests/test_cli_flows.py`` (the tiny CLIP and
I-JEPA experiments trained, overrides, export in both formats, eval, error
paths, samplers, multirun, the launchers), and the multi-task experiment
(``contrastive_ijepa.yaml``) composed with width and depth overrides and
trained for 2 steps on a NYUv2-layout tree written here."""

import json
import os

import numpy as np
import pytest
import torch

from mmlearn_tpu_torch.cli._instantiators import (
    instantiate_dataloader,
    instantiate_datasets,
    instantiate_sampler,
)
from mmlearn_tpu_torch.cli.run import build_experiment, main, run_sweep
from mmlearn_tpu_torch.conf import ConfigError, store
from mmlearn_tpu_torch.datasets.core import CombinedDataset, CombinedDatasetRatioSampler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny models of this file: under a
    parallel test run, several workers' thread pools on the same cores slow
    such steps many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = "trainer.device=cpu"


def _read_metrics(output_dir: str) -> list[dict]:
    path = os.path.join(output_dir, "metrics.jsonl")
    assert os.path.exists(path), f"no metrics.jsonl in {output_dir}"
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def clip_run(tmp_path_factory):
    """The tiny CLIP experiment trained once, with a checkpoint at its end."""
    out = str(tmp_path_factory.mktemp("clip"))
    state = main(["+experiment=tiny_clip_synthetic", CPU, f"runtime.output_dir={out}",
                  "+trainer.callbacks.ckpt._target_=mmlearn_tpu_torch.trainer.ModelCheckpoint"])
    return out, state


def test_cli_tiny_clip_synthetic_trains(clip_run):
    out, state = clip_run
    assert state.step == 30
    assert next(state.task.parameters()).device.type == "cpu"
    rows = _read_metrics(out)
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) >= 3
    assert losses[-1] < losses[0] * 0.9, losses
    assert any("validation/loss" in r for r in rows)


def test_cli_tiny_ijepa_synthetic_trains(tmp_path):
    out = str(tmp_path / "ijepa")
    state = main(["+experiment=tiny_ijepa_synthetic", CPU, f"runtime.output_dir={out}"])
    assert state.step == 20
    losses = [r["train/loss"] for r in _read_metrics(out) if "train/loss" in r]
    assert len(losses) >= 2
    assert losses[-1] < losses[0], losses


def test_cli_override_applies(tmp_path):
    state = main(["+experiment=tiny_clip_synthetic", "trainer.max_steps=3", CPU,
                  f"runtime.output_dir={tmp_path}"])
    assert state.step == 3


def test_cli_trainer_runs_on_the_card_unless_told():
    """The composed trainer targets ``cuda`` unless the config says ``cpu``;
    a mesh over more devices than the processes raises; the model axis
    (tensor parallelism) is accepted and meets the same check."""
    assert build_experiment(["+experiment=tiny_clip_synthetic"])["trainer"]["device"] == "cuda"
    with pytest.raises(ValueError, match="needs more than the 1 available"):
        main(["+experiment=tiny_clip_synthetic", CPU, "trainer.mesh_shape.data=4"])
    with pytest.raises(ValueError, match="needs more than the 1 available"):
        main(["+experiment=tiny_clip_synthetic", CPU, "trainer.mesh_shape.model=2",
              "+trainer.mesh_shape.data=1"])


def test_cli_export_job(tmp_path):
    """``job_type=export`` (``export.format=artifact``, the default) writes
    a loadable serving artifact for both towers."""
    from mmlearn_tpu_torch.serving import load_encoder

    paths = main(["+experiment=tiny_clip_synthetic", "job_type=export", CPU,
                  f"runtime.output_dir={tmp_path}"])
    assert set(paths) == {"rgb", "text"}
    serve = load_encoder(paths["rgb"], device="cpu")
    emb = serve({"rgb": np.zeros((3, 32, 32, 3), np.float32)}).numpy()
    assert emb.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-4)


def test_cli_export_hf_format(tmp_path):
    paths = main(["+experiment=tiny_clip_synthetic", "job_type=export", "export.format=hf",
                  CPU, f"runtime.output_dir={tmp_path}"])
    assert set(paths) == {"rgb", "text", "logit_scale"}
    npz = np.load(os.path.join(tmp_path, "artifacts", "rgb.hf.npz"))
    assert "blocks.0.attn.qkv.weight" in npz
    assert npz["pos_embed"].shape == (1, 17, 64)
    assert npz["head.weight"].shape == (32, 64)
    npz = np.load(os.path.join(tmp_path, "artifacts", "text.hf.npz"))
    assert "text_model.encoder.layers.1.self_attn.q_proj.weight" in npz
    assert npz["text_projection.weight"].shape == (32, 64)
    sd = torch.load(paths["rgb"], weights_only=True)
    assert sd["cls_token"].shape == (1, 1, 64)


def test_cli_export_hf_format_ijepa(tmp_path):
    paths = main(["+experiment=tiny_ijepa_synthetic", "job_type=export", "export.format=hf",
                  CPU, f"runtime.output_dir={tmp_path}"])
    assert {"encoder", "predictor"} <= set(paths)
    assert "blocks.0.mlp.0.weight" in np.load(os.path.join(tmp_path, "artifacts",
                                                           "encoder.hf.npz"))
    npz = np.load(os.path.join(tmp_path, "artifacts", "predictor.hf.npz"))
    assert "predictor_blocks.0.attn.qkv.weight" in npz and "mask_token" in npz


def test_cli_export_unknown_format():
    for fmt, match in (("onnx", "export.format"), ("stablehlo", "export.format=artifact")):
        with pytest.raises(ConfigError, match=match):
            main(["+experiment=tiny_clip_synthetic", "job_type=export", f"export.format={fmt}",
                  CPU])
    with pytest.raises(ConfigError, match="platforms"):
        main(["+experiment=tiny_clip_synthetic", "job_type=export", "export.platforms=[cpu]",
              CPU])


def test_cli_eval_job_restores_the_checkpoint(clip_run, tmp_path):
    """``job_type=eval`` restores ``resume_from_checkpoint`` and tests it:
    the test loss equals the trained task's own on the same pairs (rtol
    1e-6), a fresh task's another."""
    from mmlearn_tpu_torch.trainer import Trainer

    out, state = clip_run
    common = ["+experiment=tiny_clip_synthetic", "job_type=eval", CPU,
              "+datasets.test=${datasets.val}", "dataloader.test.batch_size=32",
              f"runtime.output_dir={tmp_path}"]
    trained = main([*common, f"resume_from_checkpoint={os.path.join(out, 'checkpoints')}"])
    fresh = main(common)
    cfg = build_experiment(common)
    loader = instantiate_dataloader(cfg["dataloader"]["test"],
                                    instantiate_datasets(cfg["datasets"]["test"]))
    want = Trainer(device="cpu").test(state.task, loader)["test/loss"]
    np.testing.assert_allclose(trained["test/loss"], want, rtol=1e-6)
    assert abs(fresh["test/loss"] - want) > 1e-3


def test_cli_error_paths(monkeypatch):
    with pytest.raises(ConfigError, match="experiment"):
        main(["+experiment=nope_does_not_exist"])
    with pytest.raises(ConfigError):
        main(["task=NoSuchTask"])
    with pytest.raises(ConfigError, match="[Mm]alformed"):
        main(["a_bare_word_is_not_an_override"])
    # the multi-host launch joins the process group the environment gives:
    # without the rendezvous variables it raises before building anything
    monkeypatch.setenv("MMLEARN_MULTIHOST", "1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK|MASTER_ADDR|WORLD_SIZE"):
        main(["+experiment=tiny_clip_synthetic", CPU])


def test_cli_help_lists_the_groups(capsys):
    main(["--help"])
    out = capsys.readouterr().out
    assert "task: ContrastivePretraining, IJEPA" in out
    assert "modules/optimizers:" in out


# -------------------------------------------------------------- flows


def test_sampler_from_config_node():
    build_experiment(["experiment_name=t"])  # registers everything
    node = store.get("dataloader/sampler", "CombinedDatasetRatioSampler")
    node["ratios"] = [0.5, 0.5]
    node["num_samples"] = 16
    target = "mmlearn_tpu_torch.datasets.builtin.synthetic.SyntheticImages"
    dataset = instantiate_datasets([{"_target_": target, "size": 16, "image_size": 8},
                                    {"_target_": target, "size": 16, "image_size": 8,
                                     "seed": 1}])
    assert isinstance(dataset, CombinedDataset)
    sampler = instantiate_sampler(node, dataset, rank=1, num_replicas=4)
    assert isinstance(sampler, CombinedDatasetRatioSampler)
    assert sampler.rank == 1 and sampler.num_replicas == 4
    assert len(list(sampler)) == 4
    batches = list(instantiate_dataloader({"batch_size": 2, "drop_last": True}, dataset,
                                          sampler=sampler))
    assert len(batches) == 2
    assert batches[0]["rgb"].shape == (2, 8, 8, 3)


def test_sampler_through_experiment_yaml(tmp_path):
    exp = tmp_path / "experiment"
    exp.mkdir()
    (exp / "sampler_exp.yaml").write_text("""
experiment_name: sampler_exp
datasets:
  train:
    _target_: mmlearn_tpu_torch.datasets.builtin.synthetic.SyntheticImages
    size: 12
    image_size: 8
dataloader:
  train:
    batch_size: 4
    sampler:
      _target_: mmlearn_tpu_torch.datasets.core.samplers.CombinedDatasetRatioSampler
      num_samples: 8
""")
    cfg = build_experiment([f"searchpath=[{tmp_path}]", "+experiment=sampler_exp"])
    sampler_cfg = cfg["dataloader"]["train"]["sampler"]
    assert sampler_cfg["num_samples"] == 8
    dataset = instantiate_datasets(cfg["datasets"]["train"])
    sampler = instantiate_sampler(sampler_cfg, dataset, rank=0, num_replicas=1)
    loader = instantiate_dataloader(
        {k: v for k, v in cfg["dataloader"]["train"].items() if k != "sampler"}, dataset,
        sampler=sampler)
    assert len(loader) == 2


def test_multirun_cartesian_product():
    cfgs = run_sweep(["experiment_name=sweep", "seed=1,2", "trainer.max_steps=3,4"],
                     print_cfg=True)
    assert len(cfgs) == 4
    assert {(c["seed"], c["trainer"]["max_steps"]) for c in cfgs} == {
        (1, 3), (1, 4), (2, 3), (2, 4)}
    assert all(f"job{i}" in c["runtime"]["output_dir"] for i, c in enumerate(cfgs))


def test_launcher_arg_parsing():
    from mmlearn_tpu_torch.cli.launcher import parse_launcher_args

    opts, rest = parse_launcher_args(["launcher=slurm", "launcher.partition=gpu",
                                      "launcher.nodes=4", "trainer.max_steps=5,10",
                                      "+experiment=x"])
    assert opts == {"kind": "slurm", "partition": "gpu", "nodes": "4"}
    assert rest == ["trainer.max_steps=5,10", "+experiment=x"]


def test_slurm_launcher_writes_scripts_and_submits(tmp_path):
    """One script a job (``sbatch`` stubbed), carrying the job's argv and
    the directives; a job over several processes exports MMLEARN_MULTIHOST=1."""
    from mmlearn_tpu_torch.cli.launcher import launch_slurm

    sbatch = tmp_path / "sbatch"
    sbatch.write_text(f"#!/bin/bash\necho submitted $1\ncat \"$1\" >> {tmp_path}/calls.txt\n")
    sbatch.chmod(0o755)
    outs = launch_slurm([["a=1", "+experiment=foo"], ["a=2", "+experiment=foo"]],
                        [str(tmp_path / "job0"), str(tmp_path / "job1")], sbatch=str(sbatch),
                        partition="gpu", nodes=1, gpus=1)
    assert len(outs) == 2 and all(o.startswith("submitted") for o in outs)
    script = (tmp_path / "job0" / "submit.sh").read_text()
    assert "#SBATCH --partition=gpu" in script and "#SBATCH --gpus=1" in script
    assert "MMLEARN_MULTIHOST=0" in script
    assert "a=1" in script and "mmlearn_tpu_torch.cli.run" in script
    assert (tmp_path / "calls.txt").read_text().count("srun") == 2
    launch_slurm([["a=1"]], [str(tmp_path / "job2")], sbatch=str(sbatch), multihost=True)
    assert "MMLEARN_MULTIHOST=1" in (tmp_path / "job2" / "submit.sh").read_text()


def test_local_parallel_launcher(tmp_path):
    """``launcher=local`` runs the jobs as two concurrent processes, a log
    each: here ``--cfg`` jobs, whose logs hold the composed config."""
    from mmlearn_tpu_torch.cli.launcher import launch_local

    rcs = launch_local([["--cfg", "+experiment=tiny_clip_synthetic", f"seed={s}"]
                        for s in (1, 2)],
                       [str(tmp_path / "j0"), str(tmp_path / "j1")], workers=2)
    assert rcs == [0, 0]
    for i, seed in enumerate((1, 2)):
        log = (tmp_path / f"j{i}" / "job.log").read_text()
        assert f"seed: {seed}" in log and "mmlearn_tpu_torch.tasks" in log


# ------------------------------------------------------------ multi-task


def test_contrastive_ijepa_trains_two_steps(tmp_path):
    """``contrastive_ijepa.yaml`` from the port's ``pkg://`` searchpath, its
    towers cut to 2 blocks of width 32 at 64 px and batch 4, 2 steps on a
    NYUv2-layout tree: the auxiliary loss logged, the teacher apart from
    the student after the steps, the checkpoint's EMA offset."""
    from chip_smoke import write_nyuv2_tree

    write_nyuv2_tree(str(tmp_path / "nyuv2"), 8, hw=(48, 64))
    tower = ["img_size=64", "+depth=2", "+embed_dim=32", "+num_heads=4", "proj_dim=16"]
    argv = ["searchpath=[pkg://mmlearn_tpu_torch.projects.multi_task.configs]",
            "+experiment=contrastive_ijepa", CPU,
            f"+datasets.train.root_dir={tmp_path / 'nyuv2'}", "+datasets.train.image_size=64",
            "dataloader.train.batch_size=4", "trainer.max_steps=2", "trainer.log_every_n_steps=1",
            f"runtime.output_dir={tmp_path / 'out'}",
            "+trainer.loggers.jsonl._target_=mmlearn_tpu_torch.trainer.JSONLLogger",
            f"+trainer.loggers.jsonl.save_dir={tmp_path / 'out'}",
            *[f"{'+' if t[0] == '+' else ''}task.encoders.{m}.{t.lstrip('+')}"
              for m in ("rgb", "depth") for t in tower]]
    state = main(argv)
    assert state.step == 2
    task = state.task
    assert task.encoders["rgb"].config["embed_dim"] == 32
    assert task.encoders["rgb"].config["remat"] and task.encoders["rgb"].dtype == torch.bfloat16
    aux = task.auxiliary_tasks["ijepa_rgb"]
    assert aux.encoder is task.encoders["rgb"]
    assert aux.ema.ema_decay == 0.996
    assert any(not torch.equal(t, s) for t, s in zip(aux.teacher.parameters(),
                                                     aux.encoder.parameters()))
    rows = [r for r in _read_metrics(str(tmp_path / "out")) if "train/loss" in r]
    assert len(rows) == 2 and all(np.isfinite(r["train/aux_ijepa_rgb_loss"]) for r in rows)
    ckpt = torch.load(tmp_path / "out" / "checkpoints" / "2" / "state.pt", weights_only=True)
    assert ckpt["task"]["auxiliary_tasks.ijepa_rgb._extra_state"] == {"ema_step_offset": 0}


def test_cli_composes_and_registers_without_jax():
    """The CLI composes the multi-task experiment, its project's store
    entries included, with jax, flax, optax, the JAX package and the root
    ``projects`` blocked."""
    import subprocess
    import sys

    from tests.test_torch_no_jax import _IMPORT_ALL, REPO

    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    code = blocked + (
        "from mmlearn_tpu_torch.cli.run import build_experiment\n"
        "from mmlearn_tpu_torch.conf import store\n"
        "cfg = build_experiment(['searchpath=[pkg://mmlearn_tpu_torch.projects.multi_task."
        "configs]', '+experiment=contrastive_ijepa'])\n"
        "assert store.has('modules/layers', 'CLSPooler')\n"
        "print(cfg['task']['auxiliary_tasks']['ijepa_rgb']['task']['_target_'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "mmlearn_tpu_torch.tasks.ijepa.IJEPA"
