"""Metric loggers, counterpart of :mod:`mmlearn_tpu.trainer.loggers`: the
console and a JSON-lines file.

The JAX package also has W&B and TensorBoard loggers; they wait (ROADMAP
P7), as do their Hydra registrations (P11). Like the JAX loggers, only the
process of rank 0 writes.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

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
