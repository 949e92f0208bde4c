"""One-cycle schedule, step for step torch's ``OneCycleLR``: counterpart of
:mod:`mmlearn_tpu.modules.lr_schedulers.onecycle`.

The schedule the BIOSCAN-CLIP recipe trains with. Two phases, as torch's
``OneCycleLR(three_phase=False, anneal_strategy="cos")``: ``max_lr /
div_factor`` annealed to ``max_lr`` over steps ``[0, pct_start *
total_steps - 1]``, then ``max_lr`` annealed to ``initial_lr /
final_div_factor``, reached at step ``total_steps - 1``. Like every schedule of the port it gives the learning
rate itself as a function of the update number, for
:func:`~mmlearn_tpu_torch.modules.lr_schedulers.schedule_lambda_lr`.
"""

from __future__ import annotations

import math
from typing import Callable

from mmlearn_tpu_torch.conf import store


@store(
    group="modules/lr_schedulers",
    name="onecycle_lr",
    zen_partial=True,
    populate_full_signature=False,
)
def onecycle_lr(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """The learning rate as a function of the step, each phase a cosine
    anneal (``end + (start - end) / 2 * (1 + cos(pi * pct))``). The JAX
    function's ``anneal_strategy="linear"`` is not ported: nothing uses
    it."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps - 1)

    def interp(start: float, end: float, pct: float) -> float:
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def schedule(step: int) -> float:
        if step <= up_end:
            return interp(initial_lr, max_lr, min(max(step / max(up_end, 1e-9), 0.0), 1.0))
        pct = (step - up_end) / max(down_end - up_end, 1e-9)
        return interp(max_lr, min_lr, min(max(pct, 0.0), 1.0))

    return schedule
