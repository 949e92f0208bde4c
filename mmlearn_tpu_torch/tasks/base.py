"""Training task base class, counterpart of :mod:`mmlearn_tpu.tasks.base`.

A task is an ``nn.Module`` that holds its modules and weights, a loss, and
the optimizer and learning-rate schedule to build for them. The JAX task
exposes pure functions of a parameter tree; here ``loss_fn(batch)`` reads
the module's own weights and autograd takes the gradient.

Weight decay applies only to parameters with ``ndim >= 2`` (kernels,
embeddings), as the JAX package's optax mask; the rest go to a parameter
group with no decay.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.modules.lr_schedulers import schedule_lambda_lr


def as_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A batch entry (numpy array or tensor) as a tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


def compute_dtype(task: nn.Module) -> torch.dtype:
    """The dtype a task's encoders compute in, read from the ``dtype``
    attribute of its modules (the towers and their layers set it): bf16
    where any computes in bf16 (the flagship), f32 otherwise. It stands in
    for the JAX trainer's ``precision``."""
    dtypes = {m.dtype for m in task.modules() if isinstance(getattr(m, "dtype", None), torch.dtype)}
    return torch.bfloat16 if torch.bfloat16 in dtypes else torch.float32


def decay_mask(module: nn.Module) -> dict[str, bool]:
    """``{parameter name: decayed}``: True for parameters with ``ndim >= 2``."""
    return {name: p.ndim >= 2 for name, p in module.named_parameters()}


class TrainingTask(nn.Module):
    """Base class for training tasks.

    Args:
        optimizer: a factory ``f(param_groups, **kw) -> Optimizer``, such as
            ``functools.partial(torch.optim.AdamW, weight_decay=0.01)``;
            defaults to AdamW at ``lr=1e-4`` without decay, the JAX package's
            default.
        lr_scheduler: a factory of a schedule ``step -> learning rate``, such
            as ``functools.partial(linear_warmup_cosine_annealing_lr,
            base_lr=1e-3, warmup_steps=100)``; ``max_steps`` is filled in
            when the factory takes it and it was not given.
        loss: the loss object the subclass calls in :meth:`loss_fn`.
        compute_validation_loss, compute_test_loss: whether the trainer's
            validation and test loops compute the loss (``validation/loss``,
            ``test/loss``).
    """

    def __init__(
        self,
        optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
        lr_scheduler: Optional[Callable[..., Callable[[int], float]]] = None,
        loss: Optional[Any] = None,
        compute_validation_loss: bool = True,
        compute_test_loss: bool = True,
    ) -> None:
        super().__init__()
        self.optimizer_factory = optimizer or functools.partial(
            torch.optim.AdamW, lr=1e-4, weight_decay=0.0
        )
        self.lr_scheduler_factory = lr_scheduler
        self.loss = loss
        self.compute_validation_loss = compute_validation_loss
        self.compute_test_loss = compute_test_loss

    def loss_fn(self, batch: Mapping[str, Any]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """``(loss, metrics)`` of one batch, differentiable in the weights."""
        raise NotImplementedError

    def validation_loss(
        self, batch: Mapping[str, Any]
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """:meth:`loss_fn` in eval mode and without gradients, the
        counterpart of the JAX trainer's ``_make_val_step`` (``loss_fn`` with
        ``deterministic=True``); the module's mode is restored after."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self.loss_fn(batch)
        finally:
            self.train(was_training)

    def prepare_batch(
        self, batch: dict[str, Any], step: int, training: bool = True
    ) -> dict[str, Any]:
        """Host-side hook on each batch before ``loss_fn`` (mask drawing,
        say); the batch as it is by default."""
        return batch

    def post_update(self, step: int) -> None:
        """Hook after the optimizer's update of step ``step`` (an EMA
        teacher, say); nothing by default."""

    def init_extras(self) -> None:
        """Re-derive the state that follows from the weights (an EMA
        teacher copied from its student, say): the trainer calls it after it
        loads ``init_overlay``, as the JAX trainer re-runs ``init_extras``
        (``trainer.py:465-486``). Nothing by default."""

    def apply_import_metadata(self, meta: dict) -> None:
        """Take the run state an imported checkpoint carries beside its
        weights (:func:`~mmlearn_tpu_torch.lightning_import.
        import_lightning_checkpoint`'s ``meta``). Nothing by default."""

    def on_checkpoint_save(self, state_dict: dict[str, Any]) -> dict[str, Any]:
        """Hook on a checkpoint's state before it is written; as it is by
        default."""
        return state_dict

    def on_checkpoint_load(self, state_dict: dict[str, Any]) -> dict[str, Any]:
        """Hook on a checkpoint's state before it is restored; as it is by
        default."""
        return state_dict

    def configure_optimizers(
        self, max_steps: Optional[int] = None
    ) -> tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LRScheduler]]:
        """The optimizer over two parameter groups (decayed, not decayed)
        and, when a schedule is configured, the ``LambdaLR`` that drives it.
        Frozen parameters (``requires_grad=False``) are left out."""
        decayed = decay_mask(self)
        params = [(n, p) for n, p in self.named_parameters() if p.requires_grad]
        groups = [
            {"params": [p for n, p in params if decayed[n]]},
            {"params": [p for n, p in params if not decayed[n]], "weight_decay": 0.0},
        ]
        optimizer = self.optimizer_factory([g for g in groups if g["params"]])
        if self.lr_scheduler_factory is None:
            return optimizer, None
        factory = self.lr_scheduler_factory
        kwargs = {}
        bound = getattr(factory, "keywords", {})
        if (max_steps is not None and "max_steps" not in bound
                and "max_steps" in inspect.signature(factory).parameters):
            kwargs["max_steps"] = max_steps
        return optimizer, schedule_lambda_lr(optimizer, factory(**kwargs))
