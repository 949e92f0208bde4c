"""Config store: group/name registry of config nodes + ``builds()``.

The port's copy of :mod:`mmlearn_tpu.conf.store`: it stands in for
hydra-zen's ``ZenStore``/``builds`` and the per-module
``@store(group=..., provider="mmlearn")`` decorators. Components self-register
at import time under config *groups* (``task``, ``datasets``,
``modules/encoders``, ...); experiment files and CLI overrides reference them
by group + name. Project code extends the framework through the same mechanism
via :data:`external_store`.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
from typing import Any, Callable, TypeVar

import torch

from mmlearn_tpu_torch.conf.config import MISSING, ConfigError, deep_copy

T = TypeVar("T")


def _target_path(obj: Any) -> str:
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", getattr(obj, "__name__", None))
    if module is None or qualname is None:
        raise ConfigError(f"Cannot derive import path for {obj!r}")
    return f"{module}.{qualname}"


def _config_value(value: Any) -> Any:
    """Convert a python default value into a YAML-safe config node."""
    if value is inspect.Parameter.empty:
        return MISSING
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, type):
        # numpy dtypes serialize as their name
        try:
            import numpy as np

            return np.dtype(value).name
        except TypeError:
            pass
    if isinstance(value, (list, tuple)):
        return [_config_value(v) for v in value]
    if isinstance(value, dict):
        return {k: _config_value(v) for k, v in value.items()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            "_target_": _target_path(type(value)),
            **{
                f.name: _config_value(getattr(value, f.name))
                for f in dataclasses.fields(value)
            },
        }
    if callable(value):
        # A class/function default (e.g. a partial'd factory): reference it.
        return {"_target_": _target_path(value), "_partial_": True}
    # Fallback: stringify (rare; keeps configs YAML-serializable).
    return str(value)


def builds(
    target: Callable,
    populate_full_signature: bool = True,
    zen_partial: bool = False,
    **overrides: Any,
) -> dict:
    """Build a ``_target_`` config dict from a callable's signature.

    Mirrors hydra-zen ``builds(...)``: every constructor argument becomes an
    overridable config entry; required args default to ``"???"``; with
    ``zen_partial=True`` instantiation yields a ``functools.partial``
    (partial optimizers and schedules).
    """
    node: dict[str, Any] = {"_target_": _target_path(target)}
    if zen_partial:
        node["_partial_"] = True
    if populate_full_signature:
        try:
            sig = inspect.signature(target)
        except (TypeError, ValueError):
            sig = None
        if sig is not None:
            for name, param in sig.parameters.items():
                if name in ("self", "args", "kwargs"):
                    continue
                if param.kind in (
                    inspect.Parameter.VAR_POSITIONAL,
                    inspect.Parameter.VAR_KEYWORD,
                ):
                    continue
                node[name] = _config_value(param.default)
    for key, value in overrides.items():
        node[key] = _config_value(value) if not isinstance(value, dict) else value
    return node


class ConfigStore:
    """Global group/name registry of config nodes."""

    def __init__(self, provider: str = "mmlearn_tpu_torch") -> None:
        self.provider = provider
        self._store: dict[str, dict[str, dict]] = {}

    # -- registration ------------------------------------------------------
    def store_node(self, group: str, name: str, node: dict) -> None:
        self._store.setdefault(group, {})[name] = deep_copy(node)

    def __call__(
        self,
        target: T | None = None,
        *,
        group: str,
        name: str | None = None,
        provider: str | None = None,  # accepted for API parity; unused
        zen_partial: bool = False,
        populate_full_signature: bool = True,
        **overrides: Any,
    ):
        """Register a class/callable (decorator or direct-call form)."""

        def _register(obj: T) -> T:
            node_name = name or getattr(obj, "__name__", None)
            if node_name is None:
                raise ConfigError("Cannot infer a config name; pass name=...")
            node = builds(
                obj,
                populate_full_signature=populate_full_signature,
                zen_partial=zen_partial,
                **overrides,
            )
            self.store_node(group, node_name, node)
            return obj

        if target is None:
            return _register
        return _register(target)

    # -- lookup ------------------------------------------------------------
    def get(self, group: str, name: str) -> dict:
        try:
            return deep_copy(self._store[group][name])
        except KeyError:
            available = sorted(self._store.get(group, {}))
            raise ConfigError(
                f"No config named '{name}' in group '{group}'. "
                f"Available: {available}"
            ) from None

    def has_group(self, group: str) -> bool:
        return group in self._store

    def has(self, group: str, name: str) -> bool:
        return name in self._store.get(group, {})

    def names(self, group: str) -> list[str]:
        return sorted(self._store.get(group, {}))

    def groups(self) -> list[str]:
        return sorted(self._store)


#: The framework-wide store. Framework modules register into this at import
#: time; the CLI imports all subpackages to trigger registration. It is the
#: port's own: the JAX package's store is another object.
store = ConfigStore(provider="mmlearn_tpu_torch")

#: Store for user/project extensions (hydra-zen's ``external_store``). Same
#: underlying registry so project configs compose with built-ins.
external_store = store


def register_external_module(
    module: Any,
    group: str,
    *,
    filter_fn: Callable[[Any], bool] | None = None,
    zen_partial: bool = False,
    **overrides: Any,
) -> None:
    """Sweep a python module and register every public class under ``group``.

    The original mmlearn's ``register_external_modules``, which it uses to
    register every torch optimizer and schedule.
    """
    for attr_name in dir(module):
        if attr_name.startswith("_"):
            continue
        obj = getattr(module, attr_name)
        if not callable(obj):
            continue
        if filter_fn is not None and not filter_fn(obj):
            continue
        try:
            node = builds(obj, zen_partial=zen_partial, **overrides)
        except ConfigError:
            continue
        store.store_node(group, attr_name, node)
