"""Multirun job launchers of the port's CLI, counterpart of
:mod:`mmlearn_tpu.cli.launcher`: parallel local subprocesses and SLURM
(``sbatch``).

- ``local``: jobs run as subprocesses with a bounded worker pool (each job
  gets a fresh process);
- ``slurm``: per-job submission scripts are written under the job dir and
  submitted with ``sbatch`` (submitit-style). With ``launcher.multihost=1``
  a job spreads over the tasks ``srun`` starts: the script exports
  ``MMLEARN_MULTIHOST=1``, and each task joins the process group from its
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, which the job's own setup exports from SLURM's).

Launcher selection from the ``-m`` command line::

    mmlearn_torch_run -m launcher=local launcher.workers=4 trainer.max_steps=5,10
    mmlearn_torch_run -m launcher=slurm launcher.partition=gpu launcher.gpus=1 ...
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence

logger = logging.getLogger(__name__)


def parse_launcher_args(argv: Sequence[str]) -> tuple[dict[str, Any], list[str]]:
    """Split ``launcher=...`` / ``launcher.key=value`` overrides from argv."""
    opts: dict[str, Any] = {}
    rest: list[str] = []
    for arg in argv:
        if arg.startswith("launcher="):
            opts["kind"] = arg.split("=", 1)[1]
        elif arg.startswith("launcher."):
            key, _, value = arg.partition("=")
            opts[key[len("launcher.") :]] = value
        else:
            rest.append(arg)
    return opts, rest


def _job_cmd(job_argv: Sequence[str]) -> list[str]:
    return [sys.executable, "-m", "mmlearn_tpu_torch.cli.run", *job_argv]


def launch_local(
    job_argvs: Sequence[Sequence[str]],
    output_dirs: Sequence[str],
    workers: int = 1,
    env: Optional[dict[str, str]] = None,
) -> list[int]:
    """Run sweep jobs as subprocesses, ``workers`` at a time.

    Returns per-job exit codes. Job stdout/stderr stream to
    ``<output_dir>/job.log``.
    """
    base_env = dict(os.environ)
    if env:
        base_env.update(env)

    def _run(idx_args):
        idx, (args, out_dir) = idx_args
        os.makedirs(out_dir, exist_ok=True)
        log_path = os.path.join(out_dir, "job.log")
        with open(log_path, "w") as log:
            proc = subprocess.run(
                _job_cmd(args), env=base_env, stdout=log,
                stderr=subprocess.STDOUT,
            )
        logger.info("multirun job %d finished rc=%d (%s)", idx,
                     proc.returncode, log_path)
        return proc.returncode

    jobs = list(enumerate(zip(job_argvs, output_dirs)))
    if workers <= 1:
        return [_run(j) for j in jobs]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(_run, jobs))


_SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={out_dir}/slurm-%j.out
{directives}
export MMLEARN_MULTIHOST={multihost}
srun {cmd}
"""


def write_sbatch_script(
    job_argv: Sequence[str],
    out_dir: str,
    name: str = "mmlearn",
    multihost: bool = False,
    **directives: Any,
) -> str:
    """Write a submitit-style sbatch script for one sweep job."""
    os.makedirs(out_dir, exist_ok=True)
    lines = [
        f"#SBATCH --{key.replace('_', '-')}={value}"
        for key, value in sorted(directives.items())
        if value is not None
    ]
    script = _SBATCH_TEMPLATE.format(
        name=name,
        out_dir=out_dir,
        directives="\n".join(lines),
        multihost=int(bool(multihost)),
        cmd=" ".join(shlex.quote(a) for a in _job_cmd(job_argv)),
    )
    path = os.path.join(out_dir, "submit.sh")
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, 0o755)
    return path


def launch_slurm(
    job_argvs: Sequence[Sequence[str]],
    output_dirs: Sequence[str],
    sbatch: str = "sbatch",
    multihost: bool = False,
    **directives: Any,
) -> list[str]:
    """Submit sweep jobs via sbatch; returns submission stdout per job.

    ``directives`` become ``#SBATCH --key=value`` lines (e.g.
    ``partition="gpu", gpus=1, time="04:00:00"``): one task a job, on one
    card.
    """
    outs = []
    for args, out_dir in zip(job_argvs, output_dirs):
        script = write_sbatch_script(
            args, out_dir, multihost=multihost, **directives
        )
        proc = subprocess.run(
            [sbatch, script], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"sbatch failed for {script}: {proc.stderr.strip()}"
            )
        outs.append(proc.stdout.strip())
        logger.info("submitted %s: %s", script, proc.stdout.strip())
    return outs
