"""Trainer callbacks, counterpart of :mod:`mmlearn_tpu.trainer.callbacks`:
checkpointing, the learning-rate monitor and a timer.

:class:`ModelCheckpoint` writes the :class:`~mmlearn_tpu_torch.trainer.state.
TrainState` (weights, the EMA teacher, the optimizer's moments, the
schedule, the step and any accumulated gradient) with ``torch.save``, in the
JAX package's layout: one directory a step under the checkpoint directory,
``<dir>/<step>/state.pt``, beside ``loop_position-<step>.json`` (the fit
loop's epoch and batch, for resuming an unsized loader mid-epoch) and
``monitored_scores.json`` (the monitored top-k pins). A step is written
under a temporary name and renamed when complete, as Orbax finalizes a
save, so a run killed mid-write never resumes from half a checkpoint.

Over several processes every rank takes part in a save (the shards of an
FSDP2 task, over ``fsdp`` and over ``model`` where its layers are split,
are gathered into whole tensors, :func:`~mmlearn_tpu_torch.
trainer.state.full_state`), rank 0 alone writes the one-device format, and
the ranks meet at a barrier once it is on disk; every rank reads a
checkpoint it restores, and cuts it to its own shards, at any world size.

The Hydra registration of the JAX classes waits for the config layer
(ROADMAP P11).
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import threading
import time
from typing import Any, Optional

import torch

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.trainer.state import full_state

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _distributed() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes checkpoint files: rank 0, or the only
    process."""
    return not _distributed() or torch.distributed.get_rank() == 0


class Callback:
    """Callback protocol: the hooks the trainer calls."""

    def on_train_start(self, trainer: Any) -> None: ...

    def on_train_batch_end(self, trainer: Any, metrics: dict, step: int) -> None: ...

    def on_train_epoch_end(self, trainer: Any, epoch: int) -> None: ...

    def on_validation_end(self, trainer: Any, metrics: dict, step: int) -> None: ...

    def on_train_end(self, trainer: Any) -> None: ...


def _map_tensors(tree: Any, fn) -> Any:
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def snapshot(state: dict) -> tuple[dict, Optional[torch.cuda.Event]]:
    """A host copy of a state dict's tensors, and the event after which it
    is complete: card tensors are copied into pinned memory on the current
    stream (ordered after the step that made them, before the next one
    changes them), CPU tensors cloned."""
    event = None

    def copy(t: torch.Tensor) -> torch.Tensor:
        nonlocal event
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
            return host
        return t.detach().clone()

    out = _map_tensors(state, copy)
    if event is not None:
        event.record()
    return out, event


def write_state(dirpath: str, step: int, state: dict) -> str:
    """Write ``state`` as the checkpoint ``<dirpath>/<step>/state.pt``:
    under a temporary name, synced, then renamed, so that the step's
    directory exists only once complete. Returns its path."""
    final = os.path.join(dirpath, str(step))
    tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    return final


@store(group="trainer/callbacks", name="ModelCheckpoint", populate_full_signature=False)
class ModelCheckpoint(Callback):
    """Periodic and last checkpoints, monitored top-k pins, and resume.

    Args:
        dirpath: the checkpoint directory; ``<default_root_dir>/checkpoints``
            by default.
        every_n_train_steps, every_n_epochs: save cadence.
        save_last: save at the end of training (a clean stop included).
        max_to_keep: the newest checkpoints kept; older ones are deleted
            unless pinned by the monitor.
        monitor, mode, save_top_k: pin the best ``save_top_k`` checkpoints by
            a validation metric (``-1``: every finite score; ``0``: none).
        async_save: copy the state to host memory on the card's stream and
            write it from a thread while training goes on.
    """

    def __init__(
        self,
        dirpath: Optional[str] = None,
        every_n_train_steps: Optional[int] = None,
        every_n_epochs: Optional[int] = 1,
        save_last: bool = True,
        max_to_keep: int = 3,
        monitor: Optional[str] = None,
        mode: str = "min",
        save_top_k: int = 1,
        async_save: bool = True,
    ) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.dirpath = dirpath
        self.every_n_train_steps = every_n_train_steps
        self.every_n_epochs = every_n_epochs
        self.save_last = save_last
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.async_save = async_save
        #: the directory once resolved and read (reset to re-read another)
        self._ckpt_path: Optional[str] = None
        #: monitored top-k as retention pins: {step: score}
        self._monitored: dict[int, float] = {}
        #: steps of the periodic and last saves, previous runs' included: the
        #: newest ``max_to_keep`` are spared by a top-k eviction
        self._periodic_steps: list[int] = []
        #: every step this run wrote: a second save of one is a no-op
        self._steps_saved_this_run: set[int] = set()
        #: writer threads not yet joined, by step, and the first error
        self._writers: dict[int, threading.Thread] = {}
        self._write_error: Optional[BaseException] = None

    # -- the directory ----------------------------------------------------------
    def _ckpt_dir(self, trainer: Any) -> str:
        """The one resolution of the checkpoint directory."""
        return os.path.abspath(
            self.dirpath or os.path.join(trainer.default_root_dir, "checkpoints"))

    def _ensure(self, trainer: Any) -> str:
        if self._ckpt_path is None:
            path = self._ckpt_dir(trainer)
            os.makedirs(path, exist_ok=True)
            for name in os.listdir(path) if _writer() else ():  # half-written steps of a run that died
                if ".tmp-" in name and name.split(".tmp-")[0].isdigit():
                    shutil.rmtree(os.path.join(path, name), ignore_errors=True)
            self._ckpt_path = path
            self._rehydrate_monitored(path)
            steps = set(self.all_steps())
            self._monitored = {s: v for s, v in self._monitored.items() if s in steps}
            self._periodic_steps = sorted(steps)
        return self._ckpt_path

    def all_steps(self) -> list[int]:
        """The steps with a complete checkpoint on disk, in order."""
        path = self._ckpt_path
        if path is None or not os.path.isdir(path):
            return []
        return sorted(int(d) for d in os.listdir(path)
                      if d.isdigit() and os.path.isfile(os.path.join(path, d, STATE_FILE)))

    def step_path(self, step: int) -> str:
        return os.path.join(self._ckpt_path, str(step))

    # -- writing ----------------------------------------------------------------
    def wait_until_finished(self) -> None:
        """Join every writer; raise the first error one met."""
        for step in list(self._writers):
            self._writers.pop(step).join()
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError("checkpoint write failed") from err

    def _write_files(self, step: int, state: dict, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            write_state(self._ckpt_path, step, state)
        except BaseException as err:  # noqa: BLE001 - re-raised by wait_until_finished
            self._write_error = err

    def _write(self, trainer: Any, step: int) -> None:
        """The one write path (periodic and monitored saves)."""
        self._ensure(trainer)
        state = full_state(trainer.state.state_dict())  # every rank: a collective
        if not _writer():
            self._steps_saved_this_run.add(step)
            return
        state, event = snapshot(state)
        if self.async_save and not _distributed():
            writer = threading.Thread(target=self._write_files, args=(step, state, event),
                                      name=f"checkpoint-{step}", daemon=True)
            self._writers[step] = writer
            writer.start()
        else:
            self._write_files(step, state, event)
            if self._write_error is not None:
                self.wait_until_finished()
        self._steps_saved_this_run.add(step)
        self._save_loop_position(trainer, step)

    def _delete(self, step: int) -> None:
        writer = self._writers.pop(step, None)
        if writer is not None:
            writer.join()
        if _writer():
            shutil.rmtree(self.step_path(step), ignore_errors=True)

    def _collect(self) -> None:
        """Delete the checkpoints past the newest ``max_to_keep`` that no pin
        holds (Orbax's ``max_to_keep`` with ``should_keep_fn``)."""
        if not self.max_to_keep:
            return
        steps = sorted(set(self.all_steps()) | set(self._writers))
        for step in steps[:-self.max_to_keep]:
            if step not in self._monitored:
                self._delete(step)

    def _save(self, trainer: Any, step: int, wait: bool = False) -> None:
        self._ensure(trainer)
        if step in self._steps_saved_this_run:
            # the same state is already saved: only record that the periodic
            # window owns the step too
            if step not in self._periodic_steps:
                self._periodic_steps.append(step)
            if wait or not self.async_save:
                self.wait_until_finished()
            return
        if step in self.all_steps():
            if step == getattr(trainer, "restored_step", None):
                return  # a completed run resumed: the end-of-train save of its own step
            logger.warning("Overwriting stale checkpoint at step %d from a previous run in %s",
                           step, self._ckpt_path)
            self._delete(step)
        self._write(trainer, step)
        self._periodic_steps.append(step)
        self._collect()
        if wait or not self.async_save:
            self.wait_until_finished()
        if _distributed():
            # the files are on disk before any rank reads or decides on them
            torch.distributed.barrier()
        logger.info("Saved checkpoint at step %d", step)

    def _save_loop_position(self, trainer: Any, step: int) -> None:
        """``loop_position-<step>.json``: the fit loop's position after the
        step, one file a step so that it matches the checkpoint restored."""
        pos = getattr(trainer, "loop_position", None)
        if pos is None or not _writer():
            return
        path = self._ckpt_path
        payload = {"step": int(step), **{k: int(v) for k, v in pos.items()}}
        try:
            with open(os.path.join(path, f"loop_position-{int(step)}.json"), "w") as f:
                json.dump(payload, f)
            keep = {int(step)} | set(self.all_steps()) | set(self._writers)
            for name in os.listdir(path):
                if name.startswith("loop_position-") and name.endswith(".json"):
                    s = name[len("loop_position-"):-len(".json")]
                    if s.isdigit() and int(s) not in keep:
                        os.unlink(os.path.join(path, name))
        except OSError as err:  # non-fatal: a sized loader's position follows from the step
            logger.warning("Could not persist loop position: %s", err)

    def read_loop_position(self, trainer: Any) -> Optional[dict]:
        """The loop position saved with the step the run restored."""
        step = getattr(trainer, "restored_step", None)
        if step is None:
            return None
        try:
            with open(os.path.join(self._ensure(trainer), f"loop_position-{step}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- monitored top-k --------------------------------------------------------
    def _scores_path(self, path: str) -> str:
        return os.path.join(path, "monitored_scores.json")

    def _rehydrate_monitored(self, path: str) -> None:
        """Reload the pins a previous run wrote. A missing, corrupt or
        hand-edited file is ignored: the pins rebuild from the metrics."""
        try:
            with open(self._scores_path(path)) as f:
                raw = json.load(f)
            self._monitored = {int(k): float(v) for k, v in raw.items()
                               if math.isfinite(float(v))}
        except FileNotFoundError:
            pass
        except (OSError, ValueError, TypeError, AttributeError) as err:
            logger.warning("Ignoring unreadable monitored scores: %s", err)

    def _persist_monitored(self, path: str) -> None:
        if not _writer():
            return
        try:
            tmp = self._scores_path(path) + f".tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in self._monitored.items()}, f)
            os.replace(tmp, self._scores_path(path))
        except OSError as err:  # non-fatal: the pins rebuild from the metrics
            logger.warning("Could not persist monitored scores: %s", err)

    @property
    def _best_scores(self) -> list[float]:
        return sorted(self._monitored.values())

    def _improves_top_k(self, score: float) -> bool:
        if self.save_top_k == -1:
            return True
        k = max(1, self.save_top_k)
        if len(self._best_scores) < k:
            return True
        worst = max(self._best_scores) if self.mode == "min" else min(self._best_scores)
        return score < worst if self.mode == "min" else score > worst

    def on_validation_end(self, trainer: Any, metrics: dict, step: int) -> None:
        if not self.monitor or self.save_top_k == 0:
            return
        if self.monitor not in metrics:
            logger.warning("ModelCheckpoint monitor '%s' not in validation metrics %s",
                           self.monitor, sorted(metrics))
            return
        score = float(metrics[self.monitor])
        if not math.isfinite(score):
            # a NaN would make every later comparison false and gate every save
            logger.warning("Monitored metric %s is %s at step %d: skipping best-checkpoint save",
                           self.monitor, score, step)
            return
        path = self._ensure(trainer)
        if not self._improves_top_k(score):
            return
        on_disk = (step in self._steps_saved_this_run
                   or step == getattr(trainer, "restored_step", None))
        if not on_disk:
            if step in self.all_steps():
                self._delete(step)  # a previous run's bytes at this step
            self._write(trainer, step)
        self._monitored[step] = score
        if self.save_top_k != -1 and len(self._monitored) > max(1, self.save_top_k):
            pick = max if self.mode == "min" else min
            evict = pick(self._monitored, key=self._monitored.get)
            del self._monitored[evict]
            if evict not in set(self._periodic_steps[-self.max_to_keep:]):
                self._delete(evict)
        self._persist_monitored(path)
        if not self.async_save:
            self.wait_until_finished()
        logger.info("Pinned monitored checkpoint at step %d (%s=%s)", step, self.monitor, score)

    def _best_step(self) -> Optional[int]:
        if not self._monitored:
            return None
        pick = min if self.mode == "min" else max
        return pick(self._monitored, key=self._monitored.get)

    @property
    def best_model_path(self) -> Optional[str]:
        """Directory of the best checkpoint by the monitored metric."""
        if self._ckpt_path is None:
            return None
        self.wait_until_finished()
        step = self._best_step()
        return None if step is None else self.step_path(step)

    # -- restoring --------------------------------------------------------------
    def _load(self, trainer: Any, step: int, strict: bool) -> None:
        with open(os.path.join(self.step_path(step), STATE_FILE), "rb") as f:
            state = torch.load(f, map_location="cpu", weights_only=True)
        skipped = trainer.state.load_state_dict(state, strict=strict)
        if skipped:
            logger.warning("Non-strict restore from step %d skipped %d entries (missing or "
                           "shape-mismatched): %s", step, len(skipped), skipped[:10])
        else:
            logger.info("Restored checkpoint from step %d", step)

    def restore_best(self, trainer: Any) -> Optional[int]:
        """Load the best checkpoint by the monitored metric into
        ``trainer.state``; returns its step, or ``None``."""
        if self._ckpt_path is None:
            return None
        self.wait_until_finished()
        step = self._best_step()
        if step is not None:
            self._load(trainer, step, strict=True)
        return step

    def restore_latest(self, trainer: Any, strict: bool = True) -> Optional[int]:
        """Load the newest complete checkpoint into ``trainer.state``;
        returns its step, or ``None`` when there is none. ``strict=False``
        takes what matches the current model and keeps the rest fresh."""
        self._ensure(trainer)
        self.wait_until_finished()
        steps = self.all_steps()
        if not steps:
            return None
        self._load(trainer, steps[-1], strict)
        return steps[-1]

    # -- hooks ------------------------------------------------------------------
    def on_train_batch_end(self, trainer: Any, metrics: dict, step: int) -> None:
        if self.every_n_train_steps and step > 0 and step % self.every_n_train_steps == 0:
            self._save(trainer, step)

    def on_train_epoch_end(self, trainer: Any, epoch: int) -> None:
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._save(trainer, int(trainer.state.step))

    def on_train_end(self, trainer: Any) -> None:
        if self.save_last:
            self._save(trainer, int(trainer.state.step), wait=True)
        else:
            self.wait_until_finished()


@store(group="trainer/callbacks", name="LearningRateMonitor", populate_full_signature=False)
class LearningRateMonitor(Callback):
    """Stamp the learning rate of the latest optimizer update into the
    logged train metrics: ``schedule(step // k - 1)`` after ``step``
    micro-batches under ``accumulate_grad_batches = k`` (the JAX monitor's
    rule; ``schedule(step - 1)`` without accumulation)."""

    def __init__(self, logging_interval: str = "step") -> None:
        self.logging_interval = logging_interval

    def on_train_batch_end(self, trainer: Any, metrics: dict, step: int) -> None:
        sched = getattr(trainer, "_lr_schedule", None)
        if sched is not None:
            k = max(1, int(getattr(trainer, "accumulate_grad_batches", 1)))
            metrics["lr"] = float(sched(max(0, step // k - 1)))


@store(group="trainer/callbacks", name="Timer", populate_full_signature=False)
class Timer(Callback):
    """Stamp ``steps_per_sec`` since the start of training into the train
    metrics (host clock: at a logged step the trainer has read the card's
    results back)."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self._count = 0

    def on_train_start(self, trainer: Any) -> None:
        self._t0 = time.perf_counter()
        self._count = 0

    def on_train_batch_end(self, trainer: Any, metrics: dict, step: int) -> None:
        self._count += 1
        elapsed = time.perf_counter() - self._t0
        if elapsed > 0:
            metrics["steps_per_sec"] = self._count / elapsed
