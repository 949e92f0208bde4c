"""The training loop, counterpart of :class:`mmlearn_tpu.trainer.Trainer`.

One micro-step (``_make_train_step`` :494-537 of the JAX trainer):
``task.prepare_batch(batch, step)``, ``task.loss_fn(batch)``, backward, the
global norm of the micro-batch's gradient (``grad_norm``). Without
accumulation the optimizer then steps: optional clipping (``"norm"``: by the
global norm, as ``optax.clip_by_global_norm``; ``"value"``: elementwise, as
``optax.clip``), the update, ``task.post_update(step)`` (an EMA teacher
follows the new weights) and the schedule's step.

Gradient accumulation has the JAX package's semantics (``optax.MultiSteps``
around the clipping and the optimizer, ``_build_tx`` :386-401), not
Lightning's: ``max_steps`` and ``state.step`` count micro-batches; the
gradients of ``k = accumulate_grad_batches`` micro-batches are kept as
their running mean (MultiSteps' ``acc + (g - acc) / (n + 1)``), which is
clipped and applied once, at the window's last micro-batch; the schedule,
built for ``max_steps`` micro-steps, advances once per optimizer step, and
``post_update`` fires once per optimizer step with its 0-based count.

The fit loop (``fit`` :634, ``_fit_loop`` :833) covers ``max_epochs`` and
``max_steps``, ``limit_{train,val,test}_batches`` (an int, a fraction or 0),
``overfit_batches`` (Lightning's: a fixed leading subset, shuffling turned
off, validated on itself; ``_apply_overfit`` :587), ``val_check_interval``,
``check_val_every_n_epoch`` and the final epoch's validation,
``num_sanity_val_steps``, ``fast_dev_run``, ``detect_anomaly``, callbacks
and loggers, ``should_stop`` and a clean stop on SIGTERM or SIGUSR1 (on the
main thread), the loop position with ``set_epoch`` where the loader has it,
a task's ``init_overlay`` (a ``state_dict`` of imported weights, checked
key by key and shape by shape, loaded before the optimizer is built, then
``task.init_extras()``: JAX :465-486), and resume from a checkpoint
(``ckpt_path``), the loader fast-forwarded to
the saved epoch and batch: through ``iter_from_batch`` where the loader has
it (the skipped batches' indices are drawn, their examples never fetched),
else by fetching and discarding. Validation and test compute the task's
loss (:meth:`~mmlearn_tpu_torch.tasks.base.TrainingTask.validation_loss`)
and run its evaluation hooks (zero-shot retrieval and classification,
embedding export); :meth:`Trainer.prepare_eval_state` restores a checkpoint
for an eval-only job.

Every training batch reaches the step through a
:class:`~mmlearn_tpu_torch.datasets.core.loader.DeviceFeeder`
(``_epoch_feeder`` :781): its producer thread does the limit and skip
accounting and ``task.prepare_batch(batch, step)`` with its own step
counter, stops at ``max_steps``, and places the batch on the card (pinned
staging, a side stream, ``prefetch_batches`` batches ahead, a dead producer
a ``TimeoutError`` after ``prefetch_timeout_s``), where ``device_normalize``
turns configured uint8 images into normalized floats and floating inputs
are cast to the task's compute dtype (:meth:`Trainer._device_inputs`).

Each step's records (``loss``, ``lr``: the rate of the optimizer update this
micro-batch goes into, ``logit_scale`` where the task reports one,
``grad_norm`` and the task's other metrics) stay on the device and are read
back every ``log_every_n_steps`` steps and at the end, so no step waits on
the card. Each micro-step's dropout, drop-path and patch-dropout masks come
from a generator on the trainer's device seeded by ``(seed, micro-step)``
(:func:`~mmlearn_tpu_torch.modules.layers.dropout.step_source`; the JAX
trainer folds the step into ``key(seed + 1)``), so a resumed run draws what
the whole run drew; validation, testing and every call outside ``fit``
draw none. The weights come seeded from the function that makes the task,
and ``seed`` also seeds the task's host-side ``prepare_batch``
(``task.prepare_seed``, as the JAX trainer sets it).

``precision`` is the JAX trainer's: ``"bf16"``, ``"bf16-mixed"`` or
``"bfloat16"`` (and the fp16 names ``"fp16"``, ``"16-mixed"``, ``"16"``,
which the JAX trainer maps to ``"bf16-mixed"``) cast floating inputs and
normalized images to bf16, any other value to f32; ``None`` takes the
dtype the task's towers compute in. The JAX trainer's XLA-only options
(``compilation_cache_dir``, ``donate_state``, the profiler trace,
``"bf16-mixed"``'s attention-score switch) have no counterpart.

Over several processes (:mod:`mmlearn_tpu_torch.parallel`): under
``MMLEARN_MULTIHOST=1`` the trainer joins the process group the environment
describes (the JAX trainer's ``jax.distributed.initialize``); where
``torch.distributed`` is initialized or ``mesh_shape`` is given it builds the
mesh (``data``, ``fsdp``, ``seq``, ``model``) and sets it as the global
mesh. The task's layers are then split over ``model`` and the task wrapped
with FSDP2 before its optimizer is built
(:func:`~mmlearn_tpu_torch.parallel.partitioning.shard_task`). A loader
whose sampler splits the data over the ``data x fsdp`` ranks yields each
rank's rows (the ranks of a ``seq`` or ``model`` group take the same ones);
a loader that yields the global batch is cut to the rank's
rows by :func:`~mmlearn_tpu_torch.parallel.mesh.shard_batch` on the feeder's
thread, after ``prepare_batch`` (so an I-JEPA batch's masks are the global
batch's). FSDP2 averages the ranks' gradients at every micro-step: each
micro-step's ``grad_norm`` and the accumulated mean (saved with a
checkpoint mid-window) are the global gradient's, as the JAX trainer's.
``grad_norm`` and clipping take the global norm over the shards, each
element once; the logged losses are the mean over the ranks (the global
loss); the FLOPs counted are a rank's (its shares of the split products),
and TFLOP/s and MFU are over the mesh (the JAX trainer's per-device count
over ``peak x mesh.size``); loggers write from
rank 0 and checkpoints are written by rank 0 (``ModelCheckpoint``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import time
from typing import Any, Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mmlearn_tpu_torch.datasets.core.loader import DeviceFeeder
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.datasets.core.samplers import RandomSampler, SequentialSampler
from mmlearn_tpu_torch.modules.layers.dropout import masks_from, step_source
from mmlearn_tpu_torch.parallel.mesh import shard_batch
from mmlearn_tpu_torch.parallel.partitioning import sync_replicated_grads
from mmlearn_tpu_torch.tasks.base import TrainingTask, as_tensor, compute_dtype
from mmlearn_tpu_torch.tasks.hooks import EvalRuntime
from mmlearn_tpu_torch.trainer.flops import FlopCounter, device_peak_tflops
from mmlearn_tpu_torch.trainer.state import TrainState

logger = logging.getLogger(__name__)


def validate_batch_shapes(batch: Mapping[str, Any], context: str = "train") -> int:
    """Check a collated batch: one leading dimension across the modality
    keys, no object dtypes, no empty arrays. Returns the batch size (0
    without a modality key)."""
    batch_dim: Optional[int] = None
    offender = None
    for key, value in batch.items():
        if isinstance(value, Mapping):
            validate_batch_shapes(value, context=f"{context}.{key}")
            continue
        if not hasattr(value, "shape") or len(value.shape) == 0:
            continue
        if getattr(value, "dtype", None) == object:
            raise ValueError(
                f"[{context}] batch key '{key}' has object dtype: collate must "
                "produce numeric arrays (strings stay python lists)")
        if int(np.prod(tuple(value.shape))) == 0:
            raise ValueError(f"[{context}] batch key '{key}' is empty")
        # only modality keys share the batch dimension (I-JEPA's masks lead
        # with the number of masks)
        if not Modalities.has_modality(str(key)):
            continue
        lead = int(value.shape[0])
        if batch_dim is None:
            batch_dim, offender = lead, key
        elif lead != batch_dim:
            raise ValueError(
                f"[{context}] inconsistent batch dims: '{offender}' has {batch_dim} but "
                f"'{key}' has {lead}")
    return batch_dim or 0


def _resolve_limit(limit: Any, loader: Any, name: str) -> Optional[int]:
    """A ``limit_*_batches`` value as a batch count: an int as it is, a
    float in [0, 1] as that fraction of the loader's length (1.0: no limit,
    0.0: the phase is off)."""
    if limit is None or isinstance(limit, int):
        return limit
    fraction = float(limit)
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"{name}={limit!r}: float limits are fractions and must lie in "
                         "[0.0, 1.0]; pass an int for an absolute batch count")
    if fraction == 1.0:
        return None
    try:
        n = len(loader)
    except TypeError:
        raise ValueError(f"{name}={limit!r}: float fractions need a sized dataloader; this "
                         "loader has no length -- pass an int batch count instead") from None
    resolved = int(n * fraction)
    if resolved == 0 and fraction > 0.0:
        raise ValueError(f"{name}={limit!r} of {n} batches resolves to 0 batches; increase "
                         "the fraction or pass an int")
    return resolved


def _batch_size_of(batch: Mapping[str, Any]) -> int:
    fallback = 0
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) > 0:
            if Modalities.has_modality(str(k)):
                return int(v.shape[0])
            fallback = fallback or int(v.shape[0])
        elif isinstance(v, list):
            fallback = fallback or len(v)
    return fallback


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _to_device(tree: Any, device: torch.device) -> Any:
    """A batch's arrays as tensors on ``device``, copied synchronously (the
    validation and test loops)."""
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) or (isinstance(tree, np.ndarray)
                                          and tree.dtype.kind in "biufc"):
        return as_tensor(tree, device)
    return tree


class Trainer:
    """The fit loop, validation and test (see the module docstring)."""

    def __init__(
        self,
        max_epochs: Optional[int] = None,
        max_steps: Optional[int] = None,
        limit_train_batches: Optional[Union[int, float]] = None,
        limit_val_batches: Optional[Union[int, float]] = None,
        limit_test_batches: Optional[Union[int, float]] = None,
        overfit_batches: Union[int, float] = 0.0,
        check_val_every_n_epoch: int = 1,
        val_check_interval: Optional[Union[int, float]] = None,
        log_every_n_steps: int = 50,
        precision: Optional[str] = None,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: Optional[float] = None,
        gradient_clip_algorithm: str = "norm",
        mesh_shape: Optional[Mapping[str, int]] = None,
        callbacks: Optional[Sequence[Any]] = None,
        loggers: Optional[Sequence[Any]] = None,
        default_root_dir: str = "outputs",
        seed: int = 0,
        num_sanity_val_steps: int = 0,
        prefetch_batches: int = 2,
        prefetch_timeout_s: float = 300.0,
        device_normalize: Optional[Mapping[str, Mapping[str, Any]]] = None,
        fast_dev_run: Any = False,
        detect_anomaly: bool = False,
        log_mfu: bool = False,
        device: torch.device | str = "cuda",
    ) -> None:
        if fast_dev_run:
            # N (default 1) train and val batches, no checkpoints
            n = 1 if fast_dev_run is True else int(fast_dev_run)
            max_epochs, max_steps = 1, n
            limit_train_batches = limit_val_batches = limit_test_batches = n
            callbacks = [c for c in (callbacks or []) if not hasattr(c, "restore_latest")]
        if gradient_clip_algorithm not in ("norm", "value"):
            raise ValueError(f"gradient_clip_algorithm must be 'norm' or 'value', got "
                             f"{gradient_clip_algorithm!r}")
        if precision in ("fp16", "16-mixed", "16"):
            precision = "bf16-mixed"  # the JAX trainer's mapping
        #: the JAX trainer's ``precision`` (see the module docstring)
        self.precision = precision
        if int(accumulate_grad_batches) < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {accumulate_grad_batches}")
        if isinstance(overfit_batches, int) and overfit_batches < 0:
            raise ValueError(f"overfit_batches={overfit_batches!r} must be >= 0 (0 disables; an "
                             "int is a batch count, a float a fraction)")
        self.max_epochs = max_epochs
        self.max_steps = None if max_steps is None else int(max_steps)
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.overfit_batches = overfit_batches
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.val_check_interval = val_check_interval
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.gradient_clip_val = gradient_clip_val
        self.gradient_clip_algorithm = gradient_clip_algorithm
        self.callbacks = list(callbacks or [])
        self.loggers = list(loggers or [])
        self.default_root_dir = default_root_dir
        self.seed = int(seed)
        self.num_sanity_val_steps = num_sanity_val_steps
        #: the feeder's queue depth: placed batches held ahead of the step
        self.prefetch_batches = max(1, int(prefetch_batches))
        #: the wait for one batch before the producer is declared dead
        self.prefetch_timeout_s = float(prefetch_timeout_s)
        #: ``{key: {"mean": ..., "std": ...}}``: uint8 images under these
        #: keys are normalized on the card
        self.device_normalize = dict(device_normalize or {})
        self._norm_stats: dict[tuple, tuple[torch.Tensor, ...]] = {}
        self._active_feeder: Optional[DeviceFeeder] = None
        #: the consumer's total wait on the feeders' queues in the last fit, s
        self._feeder_wait_s = 0.0
        self.detect_anomaly = detect_anomaly
        #: log achieved TFLOP/s (and MFU against the card's peak) from a
        #: count of the first step (:class:`~mmlearn_tpu_torch.trainer.flops.FlopCounter`)
        self.log_mfu = log_mfu
        #: FLOPs of one micro-step, counted at the first step of a fit with
        #: ``log_mfu``
        self._step_flops: Optional[float] = None
        self.device = torch.device(device)
        import torch.distributed as dist

        from mmlearn_tpu_torch.parallel.mesh import create_mesh, init_from_env, set_global_mesh

        if os.environ.get("MMLEARN_MULTIHOST") == "1":
            self.device = init_from_env(self.device)
        #: the mesh over the processes (``None``: one device, no groups)
        self.mesh = None
        if mesh_shape is not None or (dist.is_available() and dist.is_initialized()):
            shape = dict(mesh_shape or {})
            self.mesh = create_mesh(data=int(shape.get("data", -1)),
                                    fsdp=int(shape.get("fsdp", 1)),
                                    model=int(shape.get("model", 1)),
                                    seq=int(shape.get("seq", 1)),
                                    slices=int(shape.get("slices", 1)), device=self.device)
            self.device = self.mesh.device
            if self.mesh.device_mesh is not None:
                set_global_mesh(self.mesh)
        self._limit_train: Optional[int] = None
        self._val_interval: Optional[int] = None
        #: whether the fit's loader yields the global batch (cut to the rank's rows)
        self._batch_is_global = False

        self.state: Optional[TrainState] = None
        #: the step the run restored (None for a fresh run), and the loop
        #: position saved with it
        self.restored_step: Optional[int] = None
        self._restored_position: Optional[dict] = None
        #: set by a callback, a task or SIGTERM/SIGUSR1 to end training after
        #: the step in flight
        self.should_stop = False
        #: (epoch, batch_in_epoch) of the next batch, saved with checkpoints
        self.loop_position: Optional[dict] = None
        #: the schedule ``optimizer step -> learning rate``, for the LR monitor
        self._lr_schedule = None
        #: one dict of floats per micro-step taken by the last :meth:`fit`
        self.history: list[dict[str, float]] = []

    # -- setup ------------------------------------------------------------------
    def _batches_per_epoch(self, loader: Any) -> Optional[int]:
        """``len(loader)`` cut by ``limit_train_batches``; None if unsized."""
        try:
            per_epoch = len(loader)
        except TypeError:
            return None
        limit = _resolve_limit(self.limit_train_batches, loader, "limit_train_batches")
        return per_epoch if limit is None else min(per_epoch, limit)

    def _resolve_val_interval(self, loader: Any) -> Optional[int]:
        """A float ``val_check_interval`` in (0, 1] as that fraction of the
        (limited) training epoch, in steps."""
        interval = self.val_check_interval
        if interval is None or isinstance(interval, int):
            return interval
        fraction = float(interval)
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"val_check_interval={interval!r}: float intervals are fractions "
                             "of the training epoch and must lie in (0.0, 1.0]; pass an int "
                             "for an absolute step interval")
        per_epoch = self._batches_per_epoch(loader)
        if per_epoch is None:
            raise ValueError(f"val_check_interval={interval!r}: float fractions need a sized "
                             "train dataloader -- pass an int step interval instead")
        return max(1, int(per_epoch * fraction))

    def _resolve_max_steps(self, loader: Any) -> int:
        if self.max_steps is not None:
            return self.max_steps
        if self.max_epochs is not None:
            per_epoch = self._batches_per_epoch(loader)
            if per_epoch is not None:
                return self.max_epochs * per_epoch
        return 1000

    def _install_stop_handlers(self) -> dict:
        """SIGTERM and SIGUSR1 (SLURM's preemption warnings) set
        ``should_stop``, so the loop ends after the step in flight and the
        end-of-train checkpoint makes the run resumable. Returns the previous
        handlers; does nothing off the main thread."""

        def request_stop(signum, frame):
            logger.warning("Received signal %d: stopping after the current step", signum)
            self.should_stop = True

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev[sig] = signal.signal(sig, request_stop)
            except ValueError:  # not the main thread
                pass
        return prev

    def _restore(self, ckpt_path: str, strict: bool) -> None:
        """Load ``ckpt_path`` (``"last"`` or a checkpoint directory) into
        the state; ``"last"`` that finds nothing starts from scratch."""
        ckpt_cb = next((c for c in self.callbacks if hasattr(c, "restore_latest")), None)
        if ckpt_cb is None:
            from mmlearn_tpu_torch.trainer.callbacks import ModelCheckpoint

            ckpt_cb = ModelCheckpoint(dirpath=None)  # restores only: not registered
        if ckpt_path != "last":
            ckpt_cb.dirpath = ckpt_path
            ckpt_cb._ckpt_path = None
        restored = ckpt_cb.restore_latest(self, strict=strict)
        if restored is not None:
            # a completed run's end-of-train save of this step is then a no-op
            self.restored_step = int(self.state.step)
            self._restored_position = ckpt_cb.read_loop_position(self)
        elif ckpt_path == "last":
            logger.warning("ckpt_path='last': no checkpoint found, starting from scratch")
        else:
            raise FileNotFoundError(f"No checkpoint found under '{ckpt_path}'")

    def _apply_overfit(self, train_loader: Any, val_loader: Any) -> Any:
        """Lightning's ``overfit_batches``: train on a fixed leading subset
        (an int is a batch count, a float a fraction of the epoch) with
        shuffling turned off, and validate on the same batches (the
        training loader replaces the validation loader). Returns the
        validation loader."""
        if not self.overfit_batches:
            return val_loader
        n = _resolve_limit(self.overfit_batches, train_loader, "overfit_batches")
        if self.limit_train_batches not in (None, n) or (
                val_loader is not None and self.limit_val_batches not in (None, n)):
            logger.warning("overfit_batches=%r overrides limit_train_batches/limit_val_batches",
                           self.overfit_batches)
        self.limit_train_batches = n
        # every epoch replays the same leading batches
        sampler = getattr(train_loader, "sampler", None)
        if isinstance(sampler, RandomSampler):
            train_loader.sampler = SequentialSampler(train_loader.dataset)
            logger.warning("overfit_batches: train-loader shuffling disabled so each epoch "
                           "replays the same batches")
        elif getattr(sampler, "shuffle", False):
            sampler.shuffle = False
            logger.warning("overfit_batches: sampler shuffle=False so each epoch replays the "
                           "same batches")
        if val_loader is not None:
            val_loader = train_loader
            self.limit_val_batches = n
        return val_loader

    def _device_inputs(self, batch: Mapping[str, Any], dtype: torch.dtype) -> dict[str, Any]:
        """A placed batch as the step takes it (the JAX trainer's
        ``_device_normalize`` :403 and ``_cast_inputs`` :437, on the card):
        a uint8 tensor of rank 3 or more under a ``device_normalize`` key
        becomes ``(x / 255 - mean) / std`` in ``dtype`` (f32 arithmetic, each
        operation rounded as numpy rounds it on the host); an unconfigured
        uint8 image raises; other uint8 tensors pass; floating tensors, also
        in nested mappings, are cast to ``dtype``."""
        out = {}
        for key, val in batch.items():
            if isinstance(val, Mapping):
                out[key] = self._device_inputs(val, dtype)
            elif not isinstance(val, torch.Tensor):
                out[key] = val
            elif val.dtype == torch.uint8 and val.ndim >= 3:
                out[key] = self._normalized(key, val, dtype)
            elif val.is_floating_point():
                out[key] = val.to(dtype)
            else:
                out[key] = val
        return out

    def _input_dtype(self, task: TrainingTask) -> torch.dtype:
        """The dtype floating inputs are cast to: bf16 under a bf16
        ``precision``, f32 under another, the towers' without one."""
        if self.precision is None:
            return compute_dtype(task)
        if str(self.precision) in ("bf16", "bf16-mixed", "bfloat16"):
            return torch.bfloat16
        return torch.float32

    def _normalized(self, key: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        stats = self.device_normalize.get(key)
        if stats is None:
            raise ValueError(
                f"batch['{key}'] is uint8 but no normalization stats are configured -- set "
                f"trainer.device_normalize.{key}.{{mean,std}} (or use a host-side float "
                "transform)")
        if (key, x.device) not in self._norm_stats:
            # device tensors, not python scalars: a CUDA division by a
            # python scalar multiplies by its reciprocal instead
            self._norm_stats[(key, x.device)] = tuple(
                torch.as_tensor(v, dtype=torch.float32, device=x.device)
                for v in (255.0, stats["mean"], stats["std"]))
        scale, mean, std = self._norm_stats[(key, x.device)]
        return ((x.float() / scale - mean) / std).to(dtype)

    @property
    def feeder_wait_s(self) -> float:
        """The consumer's total wait on the feeders' queues since the last
        :meth:`fit` began, the open feeder's included, in seconds."""
        feeder = self._active_feeder
        return self._feeder_wait_s + (feeder.wait_s if feeder is not None else 0.0)

    def _epoch_feeder(self, task, epoch_iter, epoch_base: int, skip: int, step0: int,
                      max_steps: int, seen: list) -> DeviceFeeder:
        """One epoch's batches through a :class:`DeviceFeeder`, which yields
        ``(batch_idx, host_batch, device_batch)``. Its producer thread does
        the limit and skip accounting, ``task.prepare_batch`` with its own
        step counter and the placement; it stops at ``max_steps``.
        ``seen[0]`` counts the batches the loader yielded."""
        dtype = self._input_dtype(task)

        def source():
            s = step0
            skips = skip
            for batch_idx, raw in enumerate(epoch_iter, start=epoch_base):
                seen[0] += 1
                if self._limit_train is not None and batch_idx >= self._limit_train:
                    return
                if skips > 0:  # consumed before the checkpoint
                    skips -= 1
                    continue
                batch = task.prepare_batch(dict(raw), s)
                if self._batch_is_global:
                    batch = shard_batch(batch, self.mesh)
                yield batch_idx, batch
                s += 1
                if s >= max_steps:  # no step would take a further batch
                    return

        def device_put(item, place):
            batch_idx, batch = item
            return batch_idx, batch, self._device_inputs(place(batch), dtype)

        feeder = DeviceFeeder(source(), self.device, prefetch=self.prefetch_batches,
                              timeout_s=self.prefetch_timeout_s, device_put=device_put)
        self._active_feeder = feeder
        return feeder

    def _close_feeder(self) -> None:
        feeder, self._active_feeder = self._active_feeder, None
        if feeder is not None:
            feeder.close()
            self._feeder_wait_s += feeder.wait_s

    # -- fit --------------------------------------------------------------------
    def fit(
        self,
        task: TrainingTask,
        train_loader: Iterable[Mapping[str, Any]],
        val_loader: Optional[Iterable[Mapping[str, Any]]] = None,
        ckpt_path: Optional[str] = None,
        strict_loading: bool = True,
    ) -> TrainState:
        """Move ``task`` to the trainer's device and train it over
        ``train_loader`` (any re-iterable of batch dicts; ``set_epoch(e)``
        is called where it exists), validating on ``val_loader``; resume
        from ``ckpt_path`` (``"last"`` or a checkpoint directory)."""
        val_loader = self._apply_overfit(train_loader, val_loader)
        max_steps = self._resolve_max_steps(train_loader)
        self._limit_train = _resolve_limit(self.limit_train_batches, train_loader,
                                           "limit_train_batches")
        self._val_interval = self._resolve_val_interval(train_loader)
        try:
            if len(train_loader) == 0:
                raise ValueError("train_loader yields no batches")
        except TypeError:
            pass
        task.to(self.device).train()
        task.prepare_seed = self.seed
        overlay = getattr(task, "init_overlay", None)
        if overlay is not None:
            # imported weights (a reference Lightning checkpoint, say) land on
            # the fresh task before the optimizer is built; then the state that
            # follows from the weights is re-derived (an I-JEPA teacher is
            # copied from the imported student)
            from mmlearn_tpu_torch.lightning_import import overlay_params

            overlay_params(task, overlay)
            task.init_extras()
            logger.info("applied init overlay onto the task's weights")
        self._shard(task)
        self._batch_is_global = self._global_batches(train_loader)
        optimizer, lr_scheduler = task.configure_optimizers(max_steps=max_steps)
        self._lr_schedule = None if lr_scheduler is None else lr_scheduler.lr_lambdas[0]
        self.state = TrainState(0, task, optimizer, lr_scheduler)
        self.restored_step = None
        self._restored_position = None
        if ckpt_path is not None:
            self._restore(ckpt_path, strict_loading)

        for cb in self.callbacks:
            cb.on_train_start(self)
        self.should_stop = False
        prev_handlers = self._install_stop_handlers()
        try:
            if self.num_sanity_val_steps and val_loader is not None:
                self._run_evaluation(task, val_loader, "validation",
                                     limit_batches=self.num_sanity_val_steps, log=False)
            anomaly = (torch.autograd.set_detect_anomaly(True) if self.detect_anomaly
                       else contextlib.nullcontext())
            with anomaly:
                return self._fit_loop(task, train_loader, val_loader, max_steps)
        finally:
            self._close_feeder()  # abnormal exits release the producer too
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.device_mesh is not None

    def _shard(self, task: TrainingTask) -> None:
        """Wrap ``task`` with FSDP2 over the mesh, once (a task already
        wrapped is kept)."""
        from torch.distributed.fsdp import FSDPModule

        if self._sharded and not isinstance(task, FSDPModule):
            from mmlearn_tpu_torch.parallel.partitioning import shard_task

            shard_task(task, self.mesh)
            logger.info("task sharded with FSDP2 over mesh %s", self.mesh.shape)

    def _global_batches(self, loader: Any) -> bool:
        """Whether ``loader`` yields the global batch (cut to this rank's
        rows by ``shard_batch``) rather than this rank's rows (its sampler
        splits the data over the ``data x fsdp`` ranks)."""
        if not self._sharded or self.mesh.dp_size == 1:
            return False
        replicas = int(getattr(getattr(loader, "sampler", None), "num_replicas", 1))
        if replicas == 1:
            return True
        if replicas != self.mesh.dp_size:
            raise ValueError(
                f"the loader's sampler splits the data over {replicas} replicas; the mesh "
                f"{self.mesh.shape} has {self.mesh.dp_size} batch shards (data x fsdp): pass "
                f"rank={self.mesh.dp_rank}, num_replicas={self.mesh.dp_size}")
        return False

    def _start_position(self, train_loader: Any) -> tuple[int, int]:
        """The epoch and the batches to skip in it for the restored step."""
        step = self.state.step
        if step == 0:
            return 0, 0
        per_epoch = self._batches_per_epoch(train_loader)
        pos = self._restored_position
        if per_epoch:
            epoch, skip = divmod(step, per_epoch)
        elif pos is not None and pos.get("step") == step:
            epoch, skip = int(pos.get("epoch", 0)), int(pos.get("batch_in_epoch", 0))
        else:
            logger.warning("Resuming at step %d with an unsized loader and no saved loop "
                           "position: the stream restarts from epoch 0", step)
            return 0, 0
        logger.info("Resuming at step %d: epoch %d, skipping %d batches", step, epoch, skip)
        return epoch, skip

    def _fit_loop(self, task, train_loader, val_loader, max_steps: int) -> TrainState:
        state = self.state
        epoch, skip = self._start_position(train_loader)
        # a completed run resumed trains no more; limit_train_batches=0 turns training off
        done = state.step >= max_steps or self._limit_train == 0
        per_epoch = self._batches_per_epoch(train_loader)
        self.history = []
        self._feeder_wait_s = 0.0
        pending: list[dict[str, Any]] = []
        t_log = time.perf_counter()
        examples_since_log = steps_since_log = 0
        checked_shapes = False
        while not done:
            if self.max_epochs is not None and epoch >= self.max_epochs:
                break
            if hasattr(train_loader, "set_epoch"):
                # overfit_batches pins the epoch: epoch-seeded samplers replay
                # the same leading batches
                train_loader.set_epoch(0 if self.overfit_batches else epoch)
            epoch_iter, epoch_base = train_loader, 0
            if skip > 0 and hasattr(train_loader, "iter_from_batch"):
                # the skipped batches' indices are drawn, their examples
                # never fetched (a map-style dataset; streams fetch and drop)
                fast = train_loader.iter_from_batch(skip)
                if fast is not None:
                    epoch_iter, epoch_base, skip = fast, skip, 0
            epoch_completed = False
            seen = [0]
            feeder = self._epoch_feeder(task, epoch_iter, epoch_base, skip, state.step,
                                        max_steps, seen)
            skip = 0  # consumed by the feeder's source
            for batch_idx, host_batch, batch in feeder:
                if not checked_shapes:
                    validate_batch_shapes(host_batch)
                    checked_shapes = True
                if self.log_mfu and self._step_flops is None:
                    pending.append(self._counted_step(batch))
                else:
                    pending.append(self._train_step(batch))
                step = state.step
                self.loop_position = {"epoch": epoch, "batch_in_epoch": batch_idx + 1}
                examples_since_log += _batch_size_of(host_batch)
                steps_since_log += 1
                del host_batch, batch

                if step % self.log_every_n_steps == 0 or step >= max_steps:
                    host = self._read_back(pending)
                    now = time.perf_counter()
                    if now > t_log:
                        host["examples_per_sec"] = examples_since_log / (now - t_log)
                        if self._step_flops:
                            # every process runs its shard of the step: over the mesh
                            ranks = self.mesh.size if self._sharded else 1
                            tflops = (ranks * self._step_flops * steps_since_log
                                      / (now - t_log) / 1e12)
                            host["tflops_per_sec"] = tflops
                            peak = device_peak_tflops(self.device)
                            if peak:
                                host["mfu"] = tflops / (peak * ranks)
                    t_log, examples_since_log, steps_since_log = now, 0, 0
                    for cb in self.callbacks:
                        cb.on_train_batch_end(self, host, step)
                    for lg in self.loggers:
                        lg.log_metrics({f"train/{k}": v for k, v in host.items()}, step)
                else:
                    for cb in self.callbacks:
                        cb.on_train_batch_end(self, {}, step)

                if self._val_interval and val_loader is not None and step % self._val_interval == 0:
                    self._run_evaluation(task, val_loader, "validation", step=step)
                if step >= max_steps:
                    done = True
                    # the budget ending at an epoch's end still validates it
                    epoch_completed = per_epoch is not None and batch_idx + 1 >= per_epoch
                    break
                if self.should_stop:
                    logger.warning("Stop requested at step %d: ending training cleanly", step)
                    done = True
                    break
            self._close_feeder()
            if seen[0] == 0:
                raise ValueError(f"the loader yielded no batch after step {state.step}: a "
                                 "one-pass iterator runs out after its first pass")
            if ((not done or epoch_completed) and val_loader is not None
                    and self.val_check_interval is None
                    and (epoch + 1) % self.check_val_every_n_epoch == 0):
                self._run_evaluation(task, val_loader, "validation", step=state.step)
            if not done:
                self.loop_position = {"epoch": epoch + 1, "batch_in_epoch": 0}
            for cb in self.callbacks:
                cb.on_train_epoch_end(self, epoch)
            epoch += 1
            if self.max_epochs is None and self.max_steps is None:
                done = True
        if pending:
            self._read_back(pending)
        for cb in self.callbacks:
            cb.on_train_end(self)
        for lg in self.loggers:
            lg.finalize()
        return state

    def _counted_step(self, batch: Mapping[str, Any]) -> dict[str, Any]:
        """:meth:`_train_step` under a FLOP counter, once a fit: the FLOPs of
        one micro-step, the kernels' included."""
        with FlopCounter() as counter:
            record = self._train_step(batch)
        self._step_flops = float(counter.total())
        logger.info("Train step: %.2f GFLOPs a micro-step", self._step_flops / 1e9)
        return record

    def _train_step(self, batch: Mapping[str, Any]) -> dict[str, Any]:
        """One micro-step; returns its records, still on the device."""
        state = self.state
        task, optimizer = state.task, state.optimizer
        k = self.accumulate_grad_batches
        i = state.step
        lr = optimizer.param_groups[0]["lr"]
        optimizer.zero_grad(set_to_none=True)
        with masks_from(step_source(self.seed, i, self.device)):
            loss, metrics = task.loss_fn(batch)
        loss.backward()
        if self._sharded:
            sync_replicated_grads(task, self.mesh)
        params = state.params()
        full = [p.grad for p in params]  # FSDP2's sharded gradients are DTensors
        # their local shards: every update below is in place, on this rank's shard
        grads = [None if g is None else _local(g) for g in full]
        grad_norm = self._global_norm([g for g in full if g is not None])
        record = {"step": i, "lr": lr, **metrics, "grad_norm": grad_norm}
        state.step = i + 1
        if k > 1:
            m = i % k
            acc = state.accumulated if m else None
            if acc is None:
                for g in grads:
                    if g is not None and m:
                        g.div_(m + 1)
                state.accumulated = list(full)
            else:
                # acc + (g - acc) / (m + 1), MultiSteps' running mean, in
                # three multi-tensor launches; a first gradient (acc None) is
                # acc 0's
                both = [j for j, (a, g) in enumerate(zip(acc, grads))
                        if a is not None and g is not None]
                deltas = [grads[j] for j in both]
                acc_local = [_local(acc[j]) for j in both]
                torch._foreach_sub_(deltas, acc_local)
                torch._foreach_div_(deltas, m + 1)
                torch._foreach_add_(acc_local, deltas)
                for j, g in enumerate(grads):
                    if g is not None and acc[j] is None:
                        g.div_(m + 1)
                        acc[j] = full[j]
            for p, acc in zip(params, state.accumulated):
                p.grad = acc  # the window's mean so far
            if m < k - 1:
                return record
            full = state.accumulated
            state.accumulated = None
            clip_norm = None
        else:
            clip_norm = grad_norm
        self._clip([g for g in full if g is not None], clip_norm)
        optimizer.step()  # the applied gradient stays in .grad until the next step
        task.post_update(i // k)
        if state.lr_scheduler is not None:
            state.lr_scheduler.step()
        return record

    def _global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients as the parameters hold them:
        FSDP2's ``DTensor`` shards and the plain, replicated gradients of the
        parameters it does not manage (the 0-d logit scale). Each shard's sum
        of squares is added over the mesh axes it is sharded on (``fsdp``,
        and ``model`` for a split weight); over the others (``data``, and
        ``model`` for a parameter replicated over it: norms, biases,
        embeddings, heads) the ranks hold replicas, counted once, as are the
        plain gradients' squares. On one shard it is ``get_total_norm``'s."""
        local = [_local(g) for g in grads]
        axes = [a for a in ("fsdp", "model") if self._sharded and self.mesh.shape[a] > 1]
        if not axes or not grads:
            return torch.nn.utils.get_total_norm(local)
        import torch.distributed as dist

        sums: dict[frozenset, torch.Tensor] = {}
        for g, t in zip(grads, local):
            over = frozenset() if t is g else frozenset(
                name for name, p in zip(g.device_mesh.mesh_dim_names, g.placements)
                if p.is_shard() and name in axes)
            sums[over] = sums.get(over, torch.zeros((), device=t.device)) + (
                t.float().square().sum())
        keys = sorted(sums, key=sorted)
        vec = torch.stack([sums[k] for k in keys])
        for axis in axes:
            idx = [i for i, k in enumerate(keys) if axis in k]
            if idx:
                part = vec[idx].contiguous()
                dist.all_reduce(part, group=self.mesh.group(axis))
                vec[idx] = part
        return vec.sum().sqrt()

    def _clip(self, grads: list[torch.Tensor], norm: Optional[torch.Tensor]) -> None:
        """Clip in place the gradients as the parameters hold them (see
        :meth:`_global_norm`), by ``norm`` where it is given."""
        if not self.gradient_clip_val:
            return
        if self.gradient_clip_algorithm == "value":
            for g in grads:
                _local(g).clamp_(-self.gradient_clip_val, self.gradient_clip_val)
            return
        if norm is None:
            norm = self._global_norm(grads)
        coef = torch.clamp(self.gradient_clip_val / norm, max=1.0)
        for g in grads:
            _local(g).mul_(coef)

    def _read_back(self, pending: list[dict[str, Any]]) -> dict[str, float]:
        """Move the pending records to :attr:`history`; the last one's
        metrics (without ``step``) for the callbacks and loggers. Over
        several batch shards the losses are the ranks' mean."""
        if self._sharded and self.mesh.dp_size > 1:
            self._mean_losses(pending)
        for record in pending:
            self.history.append({k: float(v) for k, v in record.items()})
        pending.clear()
        last = self.history[-1]
        logger.info("step %d loss %.6f lr %.3e grad_norm %.4f", last["step"],
                    last["loss"], last["lr"], last["grad_norm"])
        return {k: v for k, v in last.items() if k != "step"}

    def _mean_losses(self, records: list[dict[str, Any]]) -> None:
        """Each record's losses (keys holding ``loss``) replaced in place by
        their mean over the ``data x fsdp`` ranks, in one all-reduce."""
        import torch.distributed as dist

        keys = [(i, k) for i, r in enumerate(records) for k in r if "loss" in k]
        if not keys:
            return
        values = torch.stack([torch.as_tensor(records[i][k], device=self.device).float()
                              for i, k in keys])
        dist.all_reduce(values, group=self.mesh.dp_group())
        values = (values / self.mesh.dp_size).tolist()
        for (i, k), v in zip(keys, values):
            records[i][k] = v

    # -- validation and test --------------------------------------------------
    def prepare_eval_state(
        self,
        task: TrainingTask,
        loader: Optional[Iterable[Mapping[str, Any]]] = None,
        ckpt_path: Optional[str] = None,
        strict_loading: bool = True,
    ) -> TrainState:
        """The state of an eval-only job: ``task`` on the trainer's device
        with its optimizer and schedule built as a fit builds them (so a
        training checkpoint restores into it), restored from ``ckpt_path``
        (``"last"`` or a checkpoint directory) through the registered
        ``ModelCheckpoint``'s ``restore_latest``. ``loader`` is taken for the
        JAX signature (its first batch shapes the JAX state). Raises
        ``FileNotFoundError`` when there is no checkpoint to restore."""
        del loader  # the port's modules hold their weights already
        task.to(self.device)
        task.prepare_seed = self.seed
        self._shard(task)
        optimizer, lr_scheduler = task.configure_optimizers(max_steps=1)
        self.state = TrainState(0, task, optimizer, lr_scheduler)
        if ckpt_path is not None:
            ckpt_cb = next((c for c in self.callbacks if hasattr(c, "restore_latest")), None)
            if ckpt_cb is None:
                from mmlearn_tpu_torch.trainer.callbacks import ModelCheckpoint

                ckpt_cb = ModelCheckpoint(dirpath=None)  # restores only: not registered
            if ckpt_path != "last":
                ckpt_cb.dirpath = ckpt_path
                ckpt_cb._ckpt_path = None
            if ckpt_cb.restore_latest(self, strict=strict_loading) is None:
                raise FileNotFoundError(f"No checkpoint found under '{ckpt_path}'")
        return self.state

    def validate(self, task: TrainingTask, loader: Iterable[Mapping[str, Any]]) -> dict[str, float]:
        """The validation loop over ``loader`` with the task as it is."""
        return self._run_evaluation(task, loader, "validation")

    def test(self, task: TrainingTask, loader: Iterable[Mapping[str, Any]]) -> dict[str, float]:
        """The test loop over ``loader`` with the task as it is."""
        return self._run_evaluation(task, loader, "test")

    def _run_evaluation(
        self,
        task: TrainingTask,
        loader: Iterable[Mapping[str, Any]],
        phase: str,
        step: Optional[int] = None,
        limit_batches: Optional[int] = None,
        log: bool = True,
    ) -> dict[str, float]:
        """One pass over the loader (the JAX trainer's ``_run_evaluation``
        :1078): the mean of the task's loss (``<phase>/loss``) where the task
        computes it, and the task's evaluation hooks that run in this phase
        (``EvaluationSpec.run_on_validation`` / ``run_on_test``). Each hook
        sees the host batch updated with the placed one (floats in the
        compute dtype, uint8 images normalized by ``device_normalize``); its
        metrics join the results, which are logged and passed to the
        callbacks' ``on_validation_end``."""
        task.to(self.device)
        task.prepare_seed = self.seed
        runtime = EvalRuntime(task, self.device)
        runtime.dataloader = loader
        hooks = [spec.task for spec in getattr(task, "evaluation_tasks", {}).values()
                 if (spec.run_on_validation if phase == "validation" else spec.run_on_test)]
        for hook in hooks:
            hook.on_evaluation_epoch_start(runtime)
        compute_loss = (task.compute_validation_loss if phase == "validation"
                        else task.compute_test_loss)
        name = "limit_test_batches" if phase == "test" else "limit_val_batches"
        limit = limit_batches if limit_batches is not None else _resolve_limit(
            self.limit_test_batches if phase == "test" else self.limit_val_batches, loader, name)
        if limit is not None and limit < 0:
            limit = None  # -1: the whole loader (num_sanity_val_steps=-1)
        losses = []
        dtype = self._input_dtype(task)
        self._shard(task)
        cut = self._global_batches(loader)
        for batch_idx, batch in enumerate(loader):
            if limit is not None and batch_idx >= limit:
                break  # 0 turns the phase off
            if not (compute_loss or hooks):
                continue
            batch = task.prepare_batch(dict(batch), batch_idx, training=False)
            if cut:
                batch = shard_batch(batch, self.mesh)
            placed = self._device_inputs(_to_device(batch, self.device), dtype)
            if compute_loss:
                losses.append(task.validation_loss(placed)[0].float())
            full_batch = dict(batch)
            full_batch.update(placed)
            for hook in hooks:
                hook.evaluation_step(runtime, full_batch, batch_idx)
        results: dict[str, float] = {}
        if compute_loss and self._sharded and self.mesh.dp_size > 1:
            # every rank's batches' losses (an unpadded eval sampler's shards differ)
            from mmlearn_tpu_torch.parallel.collectives import process_allgather_object

            local = torch.stack(losses).tolist() if losses else []
            losses = [v for part in process_allgather_object(local) for v in part]
            if losses:
                results[f"{phase}/loss"] = float(np.mean(losses))
        elif losses:
            results[f"{phase}/loss"] = float(np.mean(torch.stack(losses).tolist()))
        for hook in hooks:
            for k, v in (hook.on_evaluation_epoch_end(runtime) or {}).items():
                results[str(k)] = float(v)
        if log and results:
            at = step if step is not None else (self.state.step if self.state else 0)
            logger.info("%s results: %s", phase, results)
            for lg in self.loggers:
                lg.log_metrics(results, at)
            for cb in self.callbacks:
                cb.on_validation_end(self, results, at)
        return results
