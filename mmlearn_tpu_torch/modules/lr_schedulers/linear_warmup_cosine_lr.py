"""Linear warmup, then cosine annealing, counterpart of
:mod:`mmlearn_tpu.modules.lr_schedulers.linear_warmup_cosine_lr`.

The JAX package builds it as an optax schedule, ``join_schedules`` of a
``linear_schedule`` and a ``cosine_decay_schedule``;
:func:`linear_warmup_cosine_annealing_lr` is the same function of the step,
written out. :func:`schedule_lambda_lr` drives a torch optimizer with any
such function: like optax, the schedule gives the learning rate itself, and
the update number ``i`` (from 0) uses ``schedule(i)``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.optim.lr_scheduler import LambdaLR

from mmlearn_tpu_torch.conf import store


@store(
    group="modules/lr_schedulers",
    name="linear_warmup_cosine_annealing_lr",
    zen_partial=True,
    populate_full_signature=False,
)
def linear_warmup_cosine_annealing_lr(
    base_lr: float,
    warmup_steps: int,
    max_steps: int,
    start_factor: float = 1.0 / 3.0,
    eta_min: float = 0.0,
) -> Callable[[int], float]:
    """The learning rate as a function of the step.

    Warmup starts at ``base_lr * start_factor`` and ramps linearly to
    ``base_lr`` over ``warmup_steps`` (torch ``LinearLR``); then a cosine
    decays it to ``eta_min`` over ``max_steps - warmup_steps`` steps (at
    least 1) and holds it there.
    """
    init = base_lr * start_factor
    decay_steps = max(1, max_steps - warmup_steps)
    alpha = eta_min / base_lr if base_lr > 0 else 0.0

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return (init - base_lr) * (1 - step / warmup_steps) + base_lr
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def schedule_lambda_lr(
    optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]
) -> LambdaLR:
    """A ``LambdaLR`` that sets every parameter group's learning rate to
    ``schedule(step)``: the groups' base rate is set to 1 first."""
    for group in optimizer.param_groups:
        group["lr"] = 1.0
    return LambdaLR(optimizer, schedule)
