"""``mmlearn_torch_run``: the port's experiment CLI, counterpart of
:mod:`mmlearn_tpu.cli.run`. Usage is the JAX package's::

    mmlearn_torch_run 'searchpath=[pkg://my_project.configs]' \\
        +experiment=my_experiment experiment_name=run1 trainer.max_steps=100

Flow: import-time registration of every config group, compose(base +
experiment + overrides), seed (numpy and torch: the towers draw their
weights from torch's default generator), instantiate callbacks, loggers,
the trainer, datasets, samplers, dataloaders and the task, then dispatch on
``job_type``: ``train`` (``Trainer.fit``), ``eval`` (``Trainer.test`` of the
weights ``resume_from_checkpoint`` names, or of the fresh task) or
``export``. ``export.format``: ``artifact`` (the default) writes each
modality's serving artifact (:func:`mmlearn_tpu_torch.serving.save_encoder`);
``hf`` and ``torch`` write each tower's torch-ecosystem state dict
(:func:`mmlearn_tpu_torch.hf_export.export_task`) as ``<name>.hf.pt`` and
``<name>.hf.npz``. ``--help`` lists the config groups, ``--cfg`` prints the
composed config, ``-m``/``--multirun`` sweeps comma-separated values.

The trainer runs on the card (``trainer.device``: ``cuda``) unless the
config says ``cpu``. ``MMLEARN_MULTIHOST=1``, the JAX package's multi-host
launch, joins the process group the environment describes (``env://``:
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
:func:`mmlearn_tpu_torch.parallel.mp_launch.run_workers` starts N local
processes so) before anything is built: NCCL on the card, gloo on the CPU.
The samplers then take this process's place among the batch's shards
(``data x fsdp`` of ``trainer.mesh_shape``), and only rank 0 logs its
hyperparameters, writes exports and checkpoints.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any, Optional, Sequence

logger = logging.getLogger(__name__)

#: export.format values and what each writes
EXPORT_FORMATS = ("artifact", "hf", "torch")


def _register_everything() -> None:
    """Import every subpackage so the ``@store`` decorators run."""
    import mmlearn_tpu_torch.datasets  # noqa: F401
    import mmlearn_tpu_torch.datasets.builtin  # noqa: F401
    import mmlearn_tpu_torch.datasets.core.grain_loader  # noqa: F401
    import mmlearn_tpu_torch.datasets.processors  # noqa: F401
    import mmlearn_tpu_torch.modules.encoders  # noqa: F401
    import mmlearn_tpu_torch.modules.encoders.clip  # noqa: F401
    import mmlearn_tpu_torch.modules.encoders.hf_wrappers  # noqa: F401
    import mmlearn_tpu_torch.modules.layers  # noqa: F401
    import mmlearn_tpu_torch.modules.losses  # noqa: F401
    import mmlearn_tpu_torch.modules.lr_schedulers  # noqa: F401
    import mmlearn_tpu_torch.modules.metrics  # noqa: F401
    import mmlearn_tpu_torch.peft  # noqa: F401
    import mmlearn_tpu_torch.tasks  # noqa: F401
    import mmlearn_tpu_torch.trainer  # noqa: F401
    from mmlearn_tpu_torch.conf import register_default_configs

    register_default_configs()


def build_experiment(overrides: Sequence[str]) -> dict:
    """Compose the final experiment config from CLI-style overrides."""
    _register_everything()
    from mmlearn_tpu_torch.conf import base_config, compose

    return compose(base_config(), overrides=overrides)


def run_experiment(cfg: dict) -> Any:
    """Instantiate everything from a composed config and run the job."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.cli._instantiators import (
        instantiate_callbacks,
        instantiate_dataloader,
        instantiate_datasets,
        instantiate_loggers,
        instantiate_sampler,
    )
    from mmlearn_tpu_torch.conf import ConfigError, check_missing, instantiate

    if cfg.get("task") in (None, "???"):
        raise ConfigError("No task configured (set task=... or use an experiment)")
    # abort on any '???' left in the composed config
    check_missing(cfg)

    seed = cfg.get("seed")
    if seed is None:
        seed = 0
    np.random.seed(seed)
    torch.manual_seed(seed)

    if os.environ.get("MMLEARN_MULTIHOST") == "1":
        from mmlearn_tpu_torch.parallel.mesh import init_from_env

        init_from_env(cfg["trainer"].get("device"))
    output_dir = cfg.get("runtime", {}).get("output_dir", "outputs")
    os.makedirs(output_dir, exist_ok=True)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))

    callbacks = instantiate_callbacks(cfg["trainer"].get("callbacks"))
    loggers = instantiate_loggers(cfg["trainer"].get("loggers"))
    if loggers and rank == 0:
        hparams = {k: v for k, v in cfg.items() if k != "runtime"}
        for lg in loggers:
            lg.log_hyperparams(hparams)

    trainer_cfg = dict(cfg["trainer"])
    for key in ("callbacks", "loggers", "default_root_dir"):
        trainer_cfg.pop(key, None)
    trainer = instantiate(trainer_cfg, callbacks=callbacks, loggers=loggers,
                          default_root_dir=output_dir, seed=seed)
    # the samplers split the data over the batch's shards (the ranks of a
    # seq group read the same rows)
    if trainer.mesh is not None:
        shard, shards = trainer.mesh.dp_rank, trainer.mesh.dp_size
    else:
        shard, shards = rank, int(os.environ.get("WORLD_SIZE", 1))

    loaders: dict[str, Any] = {}
    for split in ("train", "val", "test"):
        dataset = instantiate_datasets(cfg["datasets"].get(split))
        if dataset is None:
            loaders[split] = None
            continue
        dl_cfg = dict(cfg["dataloader"].get(split) or {})
        sampler_cfg = dl_cfg.pop("sampler", None)
        sampler = instantiate_sampler(sampler_cfg, dataset, rank=shard, num_replicas=shards)
        loaders[split] = instantiate_dataloader(dl_cfg, dataset, sampler=sampler)
        logger.info("%s dataset: %d examples, %d batches", split, len(dataset),
                    len(loaders[split]))

    task = instantiate(cfg["task"])
    logger.info("Initialized %d parameters", sum(p.numel() for p in task.parameters()))

    init_from_lightning = cfg.get("init_from_lightning")
    if init_from_lightning:
        # an original-mmlearn (Lightning) run's weights, loaded by fit before
        # the optimizer is built; its EMA position continues
        from mmlearn_tpu_torch.lightning_import import import_lightning_checkpoint

        overlay, meta = import_lightning_checkpoint(str(init_from_lightning))
        task.init_overlay = overlay
        task.apply_import_metadata(meta)
        logger.info("initializing from Lightning checkpoint %s (global_step=%d, epoch=%d%s)",
                    init_from_lightning, meta["global_step"], meta["epoch"],
                    f", ema={meta['ema']}" if "ema" in meta else "")

    job_type = str(cfg.get("job_type", "train"))
    ckpt_path = cfg.get("resume_from_checkpoint")
    strict = bool(cfg.get("strict_loading", True))
    if job_type == "train":
        if loaders["train"] is None:
            raise ConfigError("job_type=train requires datasets.train")
        return trainer.fit(task, loaders["train"], loaders["val"], ckpt_path=ckpt_path,
                           strict_loading=strict)
    if job_type == "export":
        return _export(cfg, task, trainer, loaders, output_dir, ckpt_path, strict, rank)
    if job_type == "eval":
        if loaders["test"] is None:
            raise ConfigError("job_type=eval requires datasets.test")
        trainer.prepare_eval_state(task, loaders["test"], ckpt_path=ckpt_path,
                                   strict_loading=strict)
        return trainer.test(task, loaders["test"])
    raise ConfigError(f"Unknown job_type '{job_type}'")


def _export(cfg, task, trainer, loaders, output_dir, ckpt_path, strict, rank) -> dict:
    """``job_type=export``: restore (or keep the fresh weights), then write
    ``export.format``'s files; only rank 0 writes."""
    from mmlearn_tpu_torch.conf import ConfigError

    exp_cfg = cfg.get("export") or {}
    fmt = str(exp_cfg.get("format", "artifact")).lower()
    # checked on every process: a rank-0-only error would leave the others
    # exiting "successfully"
    if fmt == "stablehlo":
        raise ConfigError("export.format=stablehlo is the JAX package's XLA artifact; the "
                          "port writes its own: export.format=artifact")
    if fmt not in EXPORT_FORMATS:
        raise ConfigError(f"Unknown export.format '{fmt}' (expected one of {EXPORT_FORMATS})")
    if exp_cfg.get("platforms") is not None:
        raise ConfigError("export.platforms names XLA platforms; the port's artifact runs "
                          "wherever torch does: leave it null")
    loader = next((ld for ld in (loaders["test"], loaders["val"], loaders["train"])
                   if ld is not None), None)
    if loader is None:
        raise ConfigError("job_type=export requires a dataset split")
    trainer.prepare_eval_state(task, loader, ckpt_path=ckpt_path, strict_loading=strict)
    try:
        batch = task.prepare_batch(dict(next(iter(loader))), step=0, training=False)
    except StopIteration:
        raise ConfigError("job_type=export: the dataset split is empty (check "
                          "batch_size/drop_last against the dataset size)") from None
    base = exp_cfg.get("output_dir") or os.path.join(output_dir, "artifacts")
    mods = exp_cfg.get("modalities")
    if mods is None:
        mods = [m for m in getattr(task, "modalities", []) if m in batch]
    if fmt == "artifact" and not mods:
        raise ConfigError("job_type=export found no modalities to export")
    if rank != 0:
        return {}
    task.eval()
    os.makedirs(base, exist_ok=True)
    paths: dict[str, str] = {}
    if fmt in ("hf", "torch"):
        import numpy as np
        import torch

        from mmlearn_tpu_torch.hf_export import export_task

        for name, sd in export_task(task, skip_unknown=True).items():
            np.savez(os.path.join(base, f"{name}.hf.npz"),
                     **{k: v.detach().cpu().numpy() for k, v in sd.items()})
            paths[name] = os.path.join(base, f"{name}.hf.pt")
            torch.save({k: v.detach().cpu() for k, v in sd.items()}, paths[name])
            logger.info("Exported %s torch state dict to %s", name, paths[name])
        return paths
    from mmlearn_tpu_torch.serving import save_encoder

    for mod in mods:
        paths[mod] = save_encoder(os.path.join(base, str(mod)), task, mod, batch,
                                  normalize=bool(exp_cfg.get("normalize", True)))
        logger.info("Exported %s artifact to %s", mod, paths[mod])
    return paths


def main(argv: Optional[Sequence[str]] = None) -> Any:
    logging.basicConfig(
        level=os.environ.get("MMLEARN_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        from mmlearn_tpu_torch.conf import store

        _register_everything()
        print("Config groups:")
        for group in store.groups():
            print(f"  {group}: {', '.join(store.names(group))}")
        return None
    print_cfg = "--cfg" in argv
    if print_cfg:
        argv.remove("--cfg")
    multirun = False
    for flag in ("-m", "--multirun"):
        if flag in argv:
            argv.remove(flag)
            multirun = True
    if multirun:
        return run_sweep(argv, print_cfg=print_cfg)
    cfg = build_experiment(argv)
    if print_cfg:
        import yaml

        print(yaml.safe_dump(cfg, sort_keys=False, default_flow_style=False))
        return cfg
    return run_experiment(cfg)


def _split_sweep_values(raw: str) -> list[str]:
    """Split a sweep spec on commas, honoring quotes and brackets:
    ``"'a,b'"`` is ONE literal value, not a two-job sweep axis."""
    values, buf, depth, quote = [], [], 0, None
    for ch in raw:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
            buf.append(ch)
        elif ch in "[({":
            depth += 1
            buf.append(ch)
        elif ch in "])}":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            values.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    values.append("".join(buf))
    return values


def run_sweep(argv: Sequence[str], print_cfg: bool = False) -> list:
    """Sweep over comma-separated override values (cartesian product):
    ``mmlearn_torch_run -m trainer.max_steps=5,10 task.encoders.rgb.depth=2,4``.

    - default: jobs run sequentially in-process;
    - ``launcher=local launcher.workers=N``: N concurrent subprocesses;
    - ``launcher=slurm launcher.partition=... launcher.gpus=...``:
      submitit-style sbatch submission, one script per job.
    """
    import itertools

    from mmlearn_tpu_torch.cli.launcher import launch_local, launch_slurm, parse_launcher_args

    launcher_opts, argv = parse_launcher_args(argv)
    sweep_axes: list[list[str]] = []
    base_args: list[str] = []
    for arg in argv:
        key, _, raw = arg.partition("=")
        values = _split_sweep_values(raw)
        if ("=" in arg and len(values) > 1 and not raw.strip().startswith("[")
                and not key.startswith(("searchpath", "hydra."))):
            sweep_axes.append([f"{key}={v}" for v in values])
        else:
            base_args.append(arg)
    job_argvs: list[list[str]] = []
    job_dirs: list[str] = []
    combos = list(itertools.product(*sweep_axes))
    for i, combo in enumerate(combos):
        job_args = base_args + list(combo)
        # recompose with the suffixed output dir so ${runtime.output_dir}
        # interpolations (loggers, checkpoints) resolve to the job dir
        out = build_experiment(job_args).get("runtime", {}).get("output_dir", "outputs")
        job_argvs.append(job_args + [f"runtime.output_dir={out}/job{i}"])
        job_dirs.append(f"{out}/job{i}")

    kind = launcher_opts.pop("kind", None)
    if kind == "local" and not print_cfg:
        workers = int(launcher_opts.pop("workers", 1))
        return launch_local(job_argvs, job_dirs, workers=workers)
    if kind == "slurm" and not print_cfg:
        sbatch = launcher_opts.pop("sbatch", "sbatch")
        multihost = launcher_opts.pop("multihost", "0") not in ("0", "false")
        return launch_slurm(job_argvs, job_dirs, sbatch=sbatch, multihost=multihost,
                            **launcher_opts)

    results = []
    for i, (combo, job_args) in enumerate(zip(combos, job_argvs)):
        cfg = build_experiment(job_args)
        logger.info("multirun job %d: %s", i, list(combo))
        if print_cfg:
            import yaml

            print(f"# --- job {i}: {list(combo)}")
            print(yaml.safe_dump(cfg, sort_keys=False))
            results.append(cfg)
        else:
            results.append(run_experiment(cfg))
    return results


def console_main() -> int:
    """The console script's entry: :func:`main` with ``sys.argv``, exit
    code 0 once the job returns."""
    main()
    return 0


if __name__ == "__main__":
    main()
