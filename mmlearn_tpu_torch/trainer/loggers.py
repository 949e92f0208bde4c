"""Metric loggers, counterpart of :mod:`mmlearn_tpu.trainer.loggers`: the
console, a JSON-lines file, Weights & Biases (``WandbLogger`` :100) and
TensorBoard (``TensorBoardLogger`` :155).

Like the JAX loggers, only the process of rank 0 writes; the rank is
``torch.distributed``'s where a process group is initialized, else 0. The
W&B and TensorBoard loggers are no-ops with a warning where their package
is missing (``wandb``; ``tensorboard`` behind ``torch.utils.tensorboard``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping, Optional

import torch

from mmlearn_tpu_torch.conf import store

logger = logging.getLogger(__name__)


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Logger:
    """Logger protocol."""

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None: ...

    def log_hyperparams(self, params: Mapping[str, Any]) -> None: ...

    def finalize(self) -> None: ...


@store(group="trainer/logger", name="ConsoleLogger", populate_full_signature=False)
class ConsoleLogger(Logger):
    """One ``step N | key=value ...`` line through :mod:`logging` every
    ``every_n_steps`` logged steps."""

    def __init__(self, every_n_steps: int = 1) -> None:
        self.every_n_steps = every_n_steps

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if _rank() != 0 or step % self.every_n_steps != 0:
            return
        parts = []
        for k, v in metrics.items():
            try:
                parts.append(f"{k}={float(v):.5g}")
            except (TypeError, ValueError):
                parts.append(f"{k}={v}")
        logger.info("step %d | %s", step, " ".join(parts))

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        logger.info("hyperparams: %s", params)


@store(group="trainer/logger", name="JSONLLogger", populate_full_signature=False)
class JSONLLogger(Logger):
    """Append one JSON object per logged step to ``<save_dir>/metrics.jsonl``
    (``step``, ``time`` and the metrics), and the hyperparameters to
    ``<save_dir>/hparams.json``."""

    def __init__(self, save_dir: str = "outputs") -> None:
        self.save_dir = save_dir
        self._file = None

    def _ensure(self):
        if self._file is None:
            os.makedirs(self.save_dir, exist_ok=True)
            self._file = open(os.path.join(self.save_dir, "metrics.jsonl"), "a")
        return self._file

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if _rank() != 0:
            return
        record: dict[str, Any] = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        f = self._ensure()
        f.write(json.dumps(record) + "\n")
        f.flush()

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if _rank() != 0:
            return
        self._ensure()
        with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)

    def finalize(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


@store(group="trainer/logger", name="WandbLogger", populate_full_signature=False)
class WandbLogger(Logger):
    """Weights & Biases: one run opened by rank 0 (project from
    ``$WANDB_PROJECT`` unless given, ``resume="allow"``), metrics through
    ``run.log``, hyperparameters into ``run.config``; a no-op where
    ``wandb`` is not installed."""

    def __init__(
        self,
        name: Optional[str] = None,
        project: Optional[str] = None,
        save_dir: str = "outputs",
        tags: Optional[list] = None,
        resume: str = "allow",
        id: Optional[str] = None,
    ) -> None:
        self._run = None
        if _rank() != 0:
            # rank 0 only: every process would open a duplicate run and
            # fight over a configured resume id
            return
        try:
            import wandb
        except ImportError as err:
            logger.warning("wandb unavailable (%s); WandbLogger is a no-op", err)
            return
        self._run = wandb.init(
            name=name,
            project=project or os.environ.get("WANDB_PROJECT"),
            dir=save_dir,
            tags=tags,
            resume=resume,
            id=id,
        )

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._run is not None:
            self._run.log(dict(metrics), step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._run is not None:
            self._run.config.update(dict(params), allow_val_change=True)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None


@store(group="trainer/logger", name="TensorBoardLogger", populate_full_signature=False)
class TensorBoardLogger(Logger):
    """TensorBoard event files through ``torch.utils.tensorboard`` in
    ``<save_dir>/<name>/version_<n>/`` (Lightning's layout; ``n`` the next
    free version unless given), written by rank 0: scalars only (a metric
    that is not a number is skipped), hyperparameters as strings where they
    are not scalars. A no-op where ``tensorboard`` is not installed."""

    def __init__(
        self,
        save_dir: str = "outputs",
        name: str = "lightning_logs",
        version: Optional[int] = None,
    ) -> None:
        self._writer = None
        self._log_dir: Optional[str] = None
        if _rank() != 0:
            # rank 0 only: processes scanning for version_<n> at once would
            # race and interleave their events in one directory
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as err:
            logger.warning("tensorboard unavailable (%s); TensorBoardLogger is a no-op", err)
            return
        root = os.path.join(save_dir, name)
        if version is None:
            names = os.listdir(root) if os.path.isdir(root) else []
            taken = [int(d[len("version_"):]) for d in names
                     if d.startswith("version_") and d[len("version_"):].isdigit()]
            version = max(taken, default=-1) + 1
        self._log_dir = os.path.join(root, f"version_{version}")
        self._writer = SummaryWriter(log_dir=self._log_dir)

    @property
    def log_dir(self) -> Optional[str]:
        return self._log_dir

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self._writer.add_scalar(k, value, global_step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._writer is None:
            return
        flat = {k: v if isinstance(v, (int, float, bool, str)) else str(v)
                for k, v in params.items()}
        self._writer.add_hparams(flat, metric_dict={}, run_name=".")

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
            self._writer = None
