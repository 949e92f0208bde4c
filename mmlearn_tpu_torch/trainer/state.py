"""Train state, counterpart of :mod:`mmlearn_tpu.trainer.state`.

The JAX state is one immutable tree (step, params, optimizer state, extras);
here the task module holds the weights (an I-JEPA task's EMA teacher among
them) and the optimizer its moments, both updated in place, and the state
names them with the step count and the gradient accumulated over a window
of micro-batches not yet applied (``optax.MultiSteps``' ``acc_grads``).

:meth:`TrainState.state_dict` is what a checkpoint holds. The optimizer's
state and the accumulated gradient are keyed by parameter name rather than
by position, so that a checkpoint restores by name
(:meth:`TrainState.load_state_dict` with ``strict=False`` takes what
matches a changed model) and :func:`mmlearn_tpu_torch.bridge.train_state_from_jax`
can write one from a JAX train state.

A task sharded with FSDP2 holds DTensors: :func:`full_state` gathers a state
dict's shards into whole tensors (on every rank: a collective), so that a
checkpoint has the one-device format whatever the world size, and
:meth:`TrainState.load_state_dict` cuts whole tensors to the shards of the
live ones (:func:`shard_like`), so that a checkpoint restores at any world
size.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from mmlearn_tpu_torch.tasks.base import TrainingTask


def _is_dtensor(t: Any) -> bool:
    return hasattr(t, "device_mesh") and hasattr(t, "to_local")


def full_state(tree: Any) -> Any:
    """``tree`` with every DTensor gathered into a whole tensor (every rank
    of its mesh must call this, in the same order)."""
    if _is_dtensor(tree):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    return tree


def shard_like(full: torch.Tensor, like: Any) -> torch.Tensor:
    """A whole tensor as this rank's shard of ``like``'s layout (a DTensor
    of the same placements, cut locally with no communication), or as it is
    where ``like`` is a plain tensor."""
    if not _is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None)


@dataclass
class TrainState:
    """Everything that evolves during training.

    ``step`` counts micro-batches, as the JAX package's ``state.step``;
    ``accumulated`` is the running mean of the gradients of the current
    accumulation window, aligned with :meth:`params` (``None`` outside a
    window, and for a parameter that got no gradient yet)."""

    step: int
    task: TrainingTask
    optimizer: torch.optim.Optimizer
    lr_scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    accumulated: Optional[list[Optional[torch.Tensor]]] = field(default=None)

    def params(self) -> list[torch.nn.Parameter]:
        """The optimizer's parameters, group by group."""
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _names(self) -> list[str]:
        names = {p: n for n, p in self.task.named_parameters()}
        return [names[p] for p in self.params()]

    def state_dict(self) -> dict[str, Any]:
        """The task's ``state_dict``, the optimizer's state and groups and
        the accumulated gradient by parameter name, the schedule and the
        step, through the task's :meth:`~TrainingTask.on_checkpoint_save`.
        The tensors are the live ones, not copies."""
        names = self._names()
        opt = self.optimizer.state_dict()
        groups = [{**g, "params": [names[i] for i in g["params"]]} for g in opt["param_groups"]]
        accumulated = {}
        if self.accumulated is not None:
            accumulated = {n: a for n, a in zip(names, self.accumulated) if a is not None}
        state = {
            "step": int(self.step),
            "task": self.task.state_dict(),
            "optimizer": {"state": {names[i]: s for i, s in opt["state"].items()},
                          "param_groups": groups},
            "lr_scheduler": None if self.lr_scheduler is None else self.lr_scheduler.state_dict(),
            "accumulated": accumulated,
        }
        return self.task.on_checkpoint_save(state)

    def load_state_dict(self, state: dict[str, Any], strict: bool = True) -> list[str]:
        """Restore from :meth:`state_dict` in place; returns the names of
        what was left as it was.

        ``strict=True`` requires the same parameters and shapes. With
        ``strict=False`` (the JAX package's non-strict overlay) the weights
        and moments whose name and shape match are taken and the rest are
        kept fresh: a checkpoint loads across a change of the model's
        configuration. ``param_groups`` of ``None`` (a state written from a
        JAX run) keeps the optimizer's own hyperparameters."""
        state = self.task.on_checkpoint_load(state)
        skipped: list[str] = []
        own = self.task.state_dict()
        weights = {k: shard_like(v, own[k]) if torch.is_tensor(v) and k in own else v
                   for k, v in state["task"].items()}
        if strict:
            self.task.load_state_dict(weights, strict=True)
        else:
            take = {k: v for k, v in weights.items() if k in own and (
                not torch.is_tensor(v) or tuple(v.shape) == tuple(own[k].shape))}
            skipped += sorted(set(own) - set(take))
            self.task.load_state_dict(take, strict=False)

        names = self._names()
        shapes = {n: tuple(p.shape) for n, p in zip(names, self.params())}
        saved = state["optimizer"]["state"]
        if strict and set(saved) - set(names):
            raise KeyError(f"checkpoint moments of unknown parameters: "
                           f"{sorted(set(saved) - set(names))[:10]}")
        opt = self.optimizer.state_dict()
        groups = state["optimizer"]["param_groups"]
        if strict and groups is not None:
            if [g["params"] for g in groups] != [[names[i] for i in g["params"]]
                                                 for g in opt["param_groups"]]:
                raise KeyError("checkpoint parameter groups differ from the optimizer's")
            opt["param_groups"] = [{**g, "params": o["params"]}
                                   for g, o in zip(groups, opt["param_groups"])]
        opt["state"] = {}
        params = self.params()
        for i, n in enumerate(names):
            moments = saved.get(n)
            if moments is not None:
                moments = {k: shard_like(v, params[i]) if torch.is_tensor(v) and v.ndim else v
                           for k, v in moments.items()}
            if moments is not None and all(
                    not torch.is_tensor(v) or v.ndim == 0 or tuple(v.shape) == shapes[n]
                    for v in moments.values()):
                opt["state"][i] = moments
            elif strict and moments is not None:
                raise KeyError(f"checkpoint moments of {n} have another shape")
            elif saved:  # a parameter before its first update has no moments
                skipped.append(f"optimizer/{n}")
        self.optimizer.load_state_dict(opt)

        sched = self.lr_scheduler
        if sched is not None and state.get("lr_scheduler") is not None:
            sched.load_state_dict({**sched.state_dict(), **state["lr_scheduler"]})
            # LambdaLR restores its count but sets no rate: the groups would
            # keep the construction's schedule(0) until its next step
            sched._last_lr = [base * fn(sched.last_epoch)
                              for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
            for group, lr in zip(self.optimizer.param_groups, sched._last_lr):
                group["lr"] = lr
        self.step = int(state["step"])
        accumulated = state.get("accumulated") or {}
        self.accumulated = None
        if accumulated:
            self.accumulated = [
                shard_like(accumulated[n].to(p.device), p) if n in accumulated else None
                for n, p in zip(names, self.params())]
        return skipped
