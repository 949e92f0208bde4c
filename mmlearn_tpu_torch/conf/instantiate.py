"""Recursive ``_target_``-driven instantiation of config trees.

The port's copy of :mod:`mmlearn_tpu.conf.instantiate`: it stands in for
``hydra.utils.instantiate``. Supported special keys inside a dict node:

- ``_target_``: dotted import path of a class/callable to invoke.
- ``_partial_``: if true, return ``functools.partial`` instead of calling.
- ``_args_``: positional arguments list.

Any other entries become keyword arguments (recursively instantiated first).
"""

from __future__ import annotations

import functools
import importlib
from typing import Any

from mmlearn_tpu_torch.conf.config import MISSING, ConfigError


def locate(path: str) -> Any:
    """Import an object from a dotted path (module attr or nested qualname)."""
    parts = path.split(".")
    import_errors: list[Exception] = []
    for split in range(len(parts) - 1, 0, -1):
        module_path = ".".join(parts[:split])
        try:
            obj: Any = importlib.import_module(module_path)
        except ModuleNotFoundError as err:
            # only "this path doesn't exist" is a silent miss; a missing
            # TRANSITIVE dependency (err.name outside the requested path)
            # means the module exists but failed to import — keep the cause
            missing = err.name or ""
            if missing != module_path and not module_path.startswith(
                missing + "."
            ):
                import_errors.append(err)
            continue
        except ImportError as err:
            # the module EXISTS but failed to import (e.g. a broken
            # extension): remember the real cause instead of reporting a
            # misleading 'could not locate'
            import_errors.append(err)
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    if import_errors:
        raise ConfigError(
            f"Could not locate '{path}': a module on the path failed to "
            f"import — {import_errors[0]}"
        ) from import_errors[0]
    raise ConfigError(f"Could not locate '{path}'")


def is_target_node(node: Any) -> bool:
    return isinstance(node, dict) and "_target_" in node


def _contains_missing(value: Any) -> bool:
    """True if ``value`` is (or nests) the MISSING sentinel '???'."""
    if value == MISSING:
        return True
    if isinstance(value, dict):
        # nested _target_ nodes check their own kwargs when instantiated
        if "_target_" in value:
            return False
        return any(_contains_missing(v) for v in value.values())
    if isinstance(value, list):
        return any(_contains_missing(v) for v in value)
    return False


def instantiate(cfg: Any, *args: Any, _recursive_: bool = True, **kwargs: Any) -> Any:
    """Instantiate a config node (see module docstring).

    Extra ``*args``/``**kwargs`` are forwarded to the target call (kwargs
    override config entries), matching hydra's behavior for late-bound
    arguments like ``instantiate(optimizer_cfg, params)``.
    """
    if cfg is None:
        return None
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()} if _recursive_ else dict(cfg)

    target = locate(cfg["_target_"])
    partial = bool(cfg.get("_partial_", False))
    pos_args = list(cfg.get("_args_", ()))
    call_kwargs: dict[str, Any] = {}
    for key, value in cfg.items():
        if key in ("_target_", "_partial_", "_args_"):
            continue
        if _contains_missing(value):
            raise ConfigError(
                f"Missing required value '{key}' for target '{cfg['_target_']}' "
                "(set it in the experiment config or via a CLI override)"
            )
        call_kwargs[key] = instantiate(value) if _recursive_ else value
    if _recursive_:
        pos_args = [instantiate(v) for v in pos_args]
    pos_args.extend(args)
    call_kwargs.update(kwargs)

    if partial:
        return functools.partial(target, *pos_args, **call_kwargs)
    try:
        return target(*pos_args, **call_kwargs)
    except TypeError as err:
        raise ConfigError(
            f"Error instantiating '{cfg['_target_']}': {err}"
        ) from err
