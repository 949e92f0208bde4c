"""Configuration system of the port, counterpart of :mod:`mmlearn_tpu.conf`.

The port's own copy of the JAX package's config layer (host Python plus
``yaml``): a config-group store that modules register into at import time,
``builds()`` to turn constructor signatures into overridable config nodes,
experiment-YAML composition with ``defaults`` lists, interpolation,
``MISSING`` values and CLI dot-path overrides in the same grammar (see
``compose.py``). The store is the port's, apart from the JAX package's.

The top-level schema (:func:`base_config`) is the JAX one (JAX
:80-125) on the port's ``Trainer`` and ``DataLoader``: experiment_name,
job_type, seed, datasets/dataloader for train/val/test, task, trainer, tags,
resume_from_checkpoint, strict_loading, init_from_lightning, export and
runtime. :func:`register_default_configs` registers the ``torch.optim``
optimizers under the JAX package's optax names (JAX :128-193) and the
port's schedules.
"""

from __future__ import annotations

import enum
import time
from typing import Sequence

from mmlearn_tpu_torch.conf.compose import compose
from mmlearn_tpu_torch.conf.config import (
    MISSING,
    ConfigError,
    find_missing,
    get_by_path,
    merge,
    resolve_interpolations,
    set_by_path,
)
from mmlearn_tpu_torch.conf.instantiate import instantiate, locate
from mmlearn_tpu_torch.conf.store import (
    ConfigStore,
    builds,
    external_store,
    register_external_module,
    store,
)

__all__ = [
    "MISSING",
    "ConfigError",
    "ConfigStore",
    "JobType",
    "base_config",
    "builds",
    "check_missing",
    "compose",
    "external_store",
    "find_missing",
    "get_by_path",
    "instantiate",
    "locate",
    "merge",
    "register_default_configs",
    "register_external_module",
    "resolve_interpolations",
    "set_by_path",
    "store",
]


class JobType(str, enum.Enum):
    """What a run does."""

    train = "train"
    eval = "eval"
    #: write serving artifacts or torch-format state dicts
    export = "export"


def _dataloader_node() -> dict:
    from mmlearn_tpu_torch.datasets.core.loader import DataLoader

    node = builds(DataLoader)
    node.pop("dataset", None)  # injected by the CLI, not configured
    node.pop("sampler", None)
    return node


def base_config() -> dict:
    """The base config schema every experiment composes on top of."""
    from mmlearn_tpu_torch.trainer.trainer import Trainer

    trainer_node = builds(Trainer)
    trainer_node["callbacks"] = None
    trainer_node["loggers"] = None
    trainer_node["default_root_dir"] = "${runtime.output_dir}"

    return {
        "experiment_name": MISSING,
        "job_type": JobType.train.value,
        "seed": None,
        "datasets": {"train": None, "val": None, "test": None},
        "dataloader": {
            "train": _dataloader_node(),
            "val": _dataloader_node(),
            "test": _dataloader_node(),
        },
        "task": MISSING,
        "trainer": trainer_node,
        "tags": ["${experiment_name}"],
        "resume_from_checkpoint": None,
        "strict_loading": True,
        # initialize weights from an original-mmlearn (Lightning) .ckpt
        # (mmlearn_tpu_torch/lightning_import.py)
        "init_from_lightning": None,
        # job_type=export
        "export": {
            # artifact (serving.save_encoder) | hf / torch (hf_export)
            "format": "artifact",
            "modalities": None,  # default: every modality in the batch
            "output_dir": "${runtime.output_dir}/artifacts",
            "normalize": True,
            "platforms": None,  # XLA-only: must stay None
        },
        "runtime": {
            "output_dir": "outputs/${experiment_name}",
            "start_time": time.strftime("%Y-%m-%d_%H-%M-%S"),
        },
    }


#: the JAX package's optax optimizers by name, with their ``torch.optim``
#: counterpart (``None``: torch has none)
OPTIMIZERS = {
    "adam": "Adam",
    "adamw": "AdamW",
    "sgd": "SGD",
    "lamb": None,
    "lars": None,
    "lion": None,
    "adafactor": "Adafactor",
    "adagrad": "Adagrad",
    "rmsprop": "RMSprop",
    "novograd": None,
    "adabelief": None,
}

_DEFAULTS_REGISTERED = False


def register_default_configs() -> None:
    """Register the optimizers and schedules into the store (idempotent).

    ``modules/optimizers``: each ``torch.optim`` class that has an optax
    counterpart in the JAX package's list, under the optax name and its
    own (capitalised) name, as a partial. An optax name that torch lacks
    is registered as a node that raises a :class:`ConfigError` naming it
    when it is built: no other optimizer stands in for it.
    ``modules/lr_schedulers``: the port's schedules.
    """
    global _DEFAULTS_REGISTERED
    if _DEFAULTS_REGISTERED:
        return
    _DEFAULTS_REGISTERED = True

    import torch

    from mmlearn_tpu_torch.modules import lr_schedulers

    for name, torch_name in OPTIMIZERS.items():
        cls = getattr(torch.optim, torch_name, None) if torch_name else None
        if cls is None:
            node = {"_target_": f"{__name__}.unported_optimizer", "_partial_": True,
                    "name": name}
            store.store_node("modules/optimizers", name, node)
            continue
        node = builds(cls, zen_partial=True)
        node.pop("params", None)  # the task passes its parameter groups
        store.store_node("modules/optimizers", name, node)
        store.store_node("modules/optimizers", torch_name, node)

    for name in ("linear_warmup_cosine_annealing_lr", "onecycle_lr"):
        store.store_node("modules/lr_schedulers", name,
                         builds(getattr(lr_schedulers, name), zen_partial=True))


def unported_optimizer(*args, name: str, **kwargs):
    """The target of an optax optimizer name that ``torch.optim`` lacks."""
    raise ConfigError(
        f"optimizer '{name}' is an optax optimizer with no torch.optim counterpart; "
        f"the port has none (pick one of "
        f"{sorted(k for k, v in OPTIMIZERS.items() if v)})")


def check_missing(cfg: dict, allow: Sequence[str] = ()) -> None:
    """Raise with a readable message if required values are still ``???``."""
    missing = [m for m in find_missing(cfg) if m not in allow]
    if missing:
        raise ConfigError(
            "Missing required config values (set them in the experiment file "
            f"or via CLI overrides): {missing}"
        )
