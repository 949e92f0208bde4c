"""Config-to-object constructors of the CLI, counterpart of
:mod:`mmlearn_tpu.cli._instantiators`: every dataset wrapped in a
:class:`CombinedDataset`, ``rank``/``num_replicas`` injected into samplers,
callbacks and loggers type-checked.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from mmlearn_tpu_torch.conf import instantiate
from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader
from mmlearn_tpu_torch.trainer.callbacks import Callback
from mmlearn_tpu_torch.trainer.loggers import Logger

logger = logging.getLogger(__name__)


def instantiate_datasets(cfg: Any) -> Optional[CombinedDataset]:
    """Instantiate one or many dataset nodes and combine them.

    ``cfg`` may be a single ``_target_`` node, a dict of named nodes, or a
    list of nodes; all are wrapped in a single ``CombinedDataset``.
    """
    if cfg is None:
        return None
    if isinstance(cfg, dict) and "_target_" in cfg:
        nodes = [cfg]
    elif isinstance(cfg, dict):
        nodes = [v for v in cfg.values() if v is not None]
    elif isinstance(cfg, list):
        nodes = [v for v in cfg if v is not None]
    else:
        raise TypeError(f"Cannot instantiate datasets from {type(cfg).__name__}")
    datasets = [instantiate(node) for node in nodes]
    datasets = [d for d in datasets if d is not None]
    if not datasets:
        return None
    return CombinedDataset(datasets)


def instantiate_sampler(
    cfg: Any, dataset: Any, rank: Optional[int] = None,
    num_replicas: Optional[int] = None,
) -> Any:
    """Instantiate a sampler node, injecting dataset + process coordinates."""
    if cfg is None:
        return None
    kwargs: dict[str, Any] = {"dataset": dataset}
    if rank is not None:
        kwargs["rank"] = rank
    if num_replicas is not None:
        kwargs["num_replicas"] = num_replicas
    try:
        return instantiate(cfg, **kwargs)
    except TypeError:
        # samplers whose signature lacks rank/num_replicas; any OTHER
        # exception (bad ratios, validation errors) must propagate — a
        # silent retry without coordinates would de-distribute the sampler
        # and duplicate data across replicas
        return instantiate(cfg, dataset=dataset)


def instantiate_dataloader(
    cfg: Any, dataset: Any, sampler: Any = None, **overrides: Any
) -> Optional[DataLoader]:
    if dataset is None:
        return None
    cfg = dict(cfg or {})
    cfg.setdefault("_target_", "mmlearn_tpu_torch.datasets.core.loader.DataLoader")
    return instantiate(cfg, dataset=dataset, sampler=sampler, **overrides)


def _instantiate_typed_list(cfg: Any, expected: type, kind: str) -> list:
    if not cfg:
        return []
    nodes = cfg.values() if isinstance(cfg, dict) else cfg
    out = []
    for node in nodes:
        if node is None:
            continue
        obj = instantiate(node)
        if not isinstance(obj, expected):
            logger.warning(
                "%s %r does not subclass %s; keeping anyway", kind, obj,
                expected.__name__,
            )
        out.append(obj)
    return out


def instantiate_callbacks(cfg: Any) -> list[Callback]:
    return _instantiate_typed_list(cfg, Callback, "Callback")


def instantiate_loggers(cfg: Any) -> list[Logger]:
    return _instantiate_typed_list(cfg, Logger, "Logger")
