"""Checkpoint weight averaging (model soups, SWA-style), counterpart of
:mod:`mmlearn_tpu.trainer.averaging`, over the checkpoints that
:class:`~mmlearn_tpu_torch.trainer.callbacks.ModelCheckpoint` writes.

The trained float weights (the parameters the optimizer holds) are
averaged; the task's other entries (an EMA teacher, buffers) only with
``average_extras``; everything else (step, optimizer, schedule, integer
entries) comes from the last checkpoint, so the result loads like a
checkpoint of that step (:meth:`TrainState.load_state_dict
<mmlearn_tpu_torch.trainer.state.TrainState.load_state_dict>`).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional, Sequence

import torch

from mmlearn_tpu_torch.trainer.callbacks import STATE_FILE

logger = logging.getLogger(__name__)


def average_checkpoints(
    dirpath: str,
    steps: Optional[Sequence[int]] = None,
    average_extras: bool = False,
) -> dict[str, Any]:
    """Average the weights of several checkpoints in one directory.

    Args:
        dirpath: a :class:`ModelCheckpoint` directory.
        steps: the steps to average; every complete checkpoint by default.
        average_extras: also average the task's float entries that are not
            trained (an EMA teacher is already an average, so off by
            default).

    Returns the last selected checkpoint's state with ``task`` replaced by
    the soup. Float entries accumulate in f64, one checkpoint at a time, and
    are cast back to their stored type.
    """
    available = sorted(int(d) for d in os.listdir(dirpath)
                       if d.isdigit() and os.path.isfile(os.path.join(dirpath, d, STATE_FILE)))
    steps = available if steps is None else sorted(int(s) for s in steps)
    if not steps:
        raise ValueError(f"No checkpoints found in {dirpath}")
    missing = [s for s in steps if s not in available]
    if missing:
        raise ValueError(f"Steps {missing} not in {dirpath} (available: {available})")
    sums: dict[str, torch.Tensor] = {}
    last: dict[str, Any] = {}
    for s in steps:
        with open(os.path.join(dirpath, str(s), STATE_FILE), "rb") as f:
            last = torch.load(f, map_location="cpu", weights_only=True)
        trained = {n for g in last["optimizer"]["param_groups"] or [] for n in g["params"]}
        trained |= set(last["optimizer"]["state"])
        for name, value in last["task"].items():
            if (torch.is_tensor(value) and value.is_floating_point()
                    and (average_extras or name in trained)):
                acc = value.double()
                sums[name] = acc if name not in sums else sums[name] + acc
    soup = dict(last["task"])
    for name, total in sums.items():
        soup[name] = (total / len(steps)).to(soup[name].dtype)
    logger.info("Averaged %d checkpoints from %s (steps %s)", len(steps), dirpath, steps)
    return {**last, "task": soup}
