"""Evaluation hooks, counterpart of :mod:`mmlearn_tpu.tasks.hooks`.

A three-hook protocol that the trainer's evaluation loop drives. Hooks
receive an :class:`EvalRuntime`: the task, its device, the loader being
evaluated and an ``encode`` that runs the task's own in eval mode without
autograd, so metric code never touches module internals. The JAX runtime's
jit cache on the task has no counterpart; instead the runtime keeps the
last batch's embeddings, so hooks that encode the same batch (retrieval,
classification and export each do) run each tower once a batch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from mmlearn_tpu_torch.constants import MODALITY_PRESENCE_SUFFIX
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize
from mmlearn_tpu_torch.tasks.base import as_tensor, compute_dtype


def device_batch(batch: Mapping[str, Any]) -> dict[str, Any]:
    """The numeric entries of a batch (numpy arrays and tensors), nested
    mappings included: collated strings (lists, object arrays) drop out."""
    out: dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, Mapping):
            sub = device_batch(v)
            if sub:
                out[k] = sub
        elif isinstance(v, torch.Tensor) or (isinstance(v, np.ndarray) and v.dtype != object):
            out[k] = v
    return out


def _placed(batch: Mapping[str, Any], device: torch.device, dtype: torch.dtype) -> dict[str, Any]:
    """:func:`device_batch` on ``device``, floating inputs in ``dtype``."""
    out: dict[str, Any] = {}
    for k, v in device_batch(batch).items():
        if isinstance(v, Mapping):
            out[k] = _placed(v, device, dtype)
            continue
        v = as_tensor(v, device)
        out[k] = v.to(dtype) if v.is_floating_point() else v
    return out


def row_validity(
    batch: Mapping[str, Any], keys: Sequence[str], n: int, device: torch.device
) -> Optional[torch.Tensor]:
    """The rows of a batch that count, as a bool tensor on ``device``: the
    presence mask of each modality key in ``keys`` and ``batch_validity``
    (a partial batch's padding), where the batch has them; ``None`` when it
    has none. Device masks stay on the device: no host sync."""
    valid = None
    names = [f"{key}{MODALITY_PRESENCE_SUFFIX}" for key in keys] + ["batch_validity"]
    for name in names:
        if name in batch:
            mask = as_tensor(batch[name], device).reshape(-1)[:n].bool()
            valid = mask if valid is None else valid & mask
    return valid


class EvalRuntime:
    """What evaluation hooks see: the task, its device and an encode.

    The runtime computes on ``device``, the card unless the caller passes
    another; the task's parameters must already live there (the trainer
    moves the task before it builds the runtime), else it raises.
    ``dataloader`` is set by the trainer to the loader being evaluated
    (classification reads its datasets' labels and prompt templates).
    """

    def __init__(self, task: Any, device: torch.device | str = "cuda") -> None:
        self.task = task
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        held = next(task.parameters()).device
        if held != device:
            raise ValueError(
                f"EvalRuntime on {device}, but the task's parameters are on {held}: move the "
                "task there first, or pass its device")
        self.device = device
        self.dataloader: Any = None
        # the batch last encoded (held, so its identity cannot be reused)
        # and its un-normalized embeddings by modality
        self._batch: Optional[Mapping[str, Any]] = None
        self._encoded: dict[str, torch.Tensor] = {}

    def encode(
        self, batch: Mapping[str, Any], modality: str, normalize: bool = False
    ) -> torch.Tensor:
        """The task's ``encode`` of ``batch`` on the runtime's device, in
        eval mode under ``torch.inference_mode()``, floating inputs in the
        task's compute dtype; the embeddings come back in that dtype, or
        with ``normalize`` L2-normalized in f32. (The task's own ``encode``
        normalizes in its compute dtype, as the JAX package does: in bf16 a
        row's norm then lies up to 2^-8 from 1, enough for a near-duplicate
        to outscore the row itself in an exported index.) The task's
        train/eval mode is restored after.

        A modality of the same batch object is encoded once, and both
        forms come from that one forward."""
        if batch is not self._batch:
            self._batch, self._encoded = batch, {}
        if modality not in self._encoded:
            task = self.task
            inputs = _placed(batch, self.device, compute_dtype(task))
            was_training = task.training
            task.eval()
            try:
                with torch.inference_mode():
                    self._encoded[modality] = task.encode(inputs, modality, normalize=False)
            finally:
                task.train(was_training)
        out = self._encoded[modality]
        if normalize:
            with torch.inference_mode():
                out = l2_normalize(out.float())
        return out


class EvaluationHooks:
    """Base class of evaluation tasks."""

    def on_evaluation_epoch_start(self, runtime: EvalRuntime) -> None:
        """Prepare metric state (class embeddings, say)."""

    def evaluation_step(
        self, runtime: EvalRuntime, batch: Mapping[str, Any], batch_idx: int
    ) -> Optional[Mapping[str, Any]]:
        """Accumulate metric state for one batch."""

    def on_evaluation_epoch_end(self, runtime: EvalRuntime) -> Optional[dict[str, Any]]:
        """Compute and return the metrics, and reset the state."""
        return None
