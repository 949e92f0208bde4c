"""A minimal trainer, counterpart of the step of
:class:`mmlearn_tpu.trainer.Trainer` (``_build_tx`` :386,
``_make_train_step`` :494-537, ``fit`` :634).

One step: ``task.prepare_batch(batch, step)``, ``task.loss_fn(batch)``,
backward, the global gradient norm, optional clipping (``"norm"``: by the
global norm, as ``optax.clip_by_global_norm``; ``"value"``: elementwise, as
``optax.clip``), the optimizer update, ``task.post_update(step)`` (an EMA
teacher follows the new weights) and the schedule's step. Each step records ``loss``,
``lr`` (the rate that step used), ``logit_scale`` where the task reports
one, and ``grad_norm`` (before clipping), plus the task's other metrics.
The records stay on the device and are read back every
``log_every_n_steps`` steps and at the end, so the host does not wait on
the card each step.

Not ported yet (ROADMAP P7): validation, callbacks, checkpoints, gradient
accumulation, preemption, device input. The step draws no random numbers on
the device (the towers' dropout rates are 0): the weights come seeded from
the function that makes the task, and ``seed`` seeds only the task's
host-side ``prepare_batch`` (``task.prepare_seed``, as the JAX trainer sets
it).
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, Mapping, Optional

import torch

from mmlearn_tpu_torch.tasks.base import TrainingTask
from mmlearn_tpu_torch.trainer.state import TrainState

logger = logging.getLogger(__name__)


class Trainer:
    """Runs ``max_steps`` training steps of a task over a loader."""

    def __init__(
        self,
        max_steps: int,
        log_every_n_steps: int = 50,
        gradient_clip_val: Optional[float] = None,
        gradient_clip_algorithm: str = "norm",
        device: torch.device | str = "cuda",
        seed: int = 0,
    ) -> None:
        if gradient_clip_algorithm not in ("norm", "value"):
            raise ValueError(
                f"gradient_clip_algorithm must be 'norm' or 'value', got "
                f"{gradient_clip_algorithm!r}"
            )
        self.max_steps = int(max_steps)
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        self.gradient_clip_val = gradient_clip_val
        self.gradient_clip_algorithm = gradient_clip_algorithm
        self.device = torch.device(device)
        self.seed = int(seed)
        #: one dict of floats per step taken by the last :meth:`fit`
        self.history: list[dict[str, float]] = []

    def fit(self, task: TrainingTask, loader: Iterable[Mapping[str, Any]]) -> TrainState:
        """Move ``task`` to the trainer's device and take ``max_steps``
        steps, cycling over ``loader`` as often as needed."""
        task.to(self.device).train()
        task.prepare_seed = self.seed
        optimizer, lr_scheduler = task.configure_optimizers(max_steps=self.max_steps)
        state = TrainState(0, task, optimizer, lr_scheduler)
        params = [p for group in optimizer.param_groups for p in group["params"]]
        self.history = []
        pending: list[dict[str, Any]] = []
        while state.step < self.max_steps:
            empty = True
            for batch in loader:
                empty = False
                pending.append(self._step(state, batch, params))
                if len(pending) == self.log_every_n_steps or state.step == self.max_steps:
                    self._read_back(pending)
                if state.step == self.max_steps:
                    break
            if empty:
                raise ValueError(
                    f"the loader yielded no batch after step {state.step}: a "
                    "one-pass iterator runs out after its first pass"
                )
        return state

    def _step(self, state: TrainState, batch: Mapping[str, Any], params) -> dict[str, Any]:
        optimizer = state.optimizer
        lr = optimizer.param_groups[0]["lr"]
        optimizer.zero_grad(set_to_none=True)
        batch = state.task.prepare_batch(dict(batch), state.step)
        loss, metrics = state.task.loss_fn(batch)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm(grads)
        if self.gradient_clip_val:
            if self.gradient_clip_algorithm == "value":
                for g in grads:
                    g.clamp_(-self.gradient_clip_val, self.gradient_clip_val)
            else:
                coef = torch.clamp(self.gradient_clip_val / grad_norm, max=1.0)
                for g in grads:
                    g.mul_(coef)
        optimizer.step()
        state.task.post_update(state.step)
        if state.lr_scheduler is not None:
            state.lr_scheduler.step()
        state.step += 1
        return {"step": state.step - 1, "lr": lr, **metrics, "grad_norm": grad_norm}

    def _read_back(self, pending: list[dict[str, Any]]) -> None:
        for record in pending:
            self.history.append({k: float(v) for k, v in record.items()})
        last = self.history[-1]
        logger.info("step %d loss %.6f lr %.3e grad_norm %.4f", last["step"],
                    last["loss"], last["lr"], last["grad_norm"])
        pending.clear()
