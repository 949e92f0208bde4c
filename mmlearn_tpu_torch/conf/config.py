"""Plain-dict config primitives: merge, interpolation, missing-value checks.

The port's copy of :mod:`mmlearn_tpu.conf.config`. This module (together
with ``store.py``, ``instantiate.py`` and ``compose.py``) is a
self-contained, dependency-free reimplementation of the configuration
capabilities the original mmlearn gets from Hydra + hydra-zen + OmegaConf.
Configs are plain nested ``dict``/``list`` trees; special string values:

- ``"???"`` (:data:`MISSING`) marks a required value that must be provided
  by an experiment file or CLI override before instantiation.
- ``"${a.b.c}"`` interpolates another config value.
- ``"${env:VAR}"`` / ``"${env:VAR,default}"`` interpolates an environment
  variable (OmegaConf's ``${oc.env:...}`` is accepted too).
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class ConfigError(Exception):
    """Raised on malformed configs, bad overrides, or unresolved values."""


def deep_copy(cfg: Any) -> Any:
    return copy.deepcopy(cfg)


def merge(base: Any, override: Any) -> Any:
    """Deep-merge ``override`` into ``base``, returning a new tree.

    Dicts merge recursively; any other type (including lists) replaces the
    base value wholesale, matching OmegaConf's default merge semantics.
    """
    if isinstance(base, dict) and isinstance(override, dict):
        out = {k: deep_copy(v) for k, v in base.items()}
        for k, v in override.items():
            if k in out:
                out[k] = merge(out[k], v)
            else:
                out[k] = deep_copy(v)
        return out
    return deep_copy(override)


def get_by_path(cfg: Any, path: str) -> Any:
    """Fetch ``cfg[a][b][c]`` for ``path == 'a.b.c'`` (int keys index lists)."""
    node = cfg
    for part in path.split("."):
        if isinstance(node, list):
            node = node[int(part)]
        elif isinstance(node, dict):
            if part not in node:
                raise KeyError(path)
            node = node[part]
        else:
            raise KeyError(path)
    return node


def set_by_path(cfg: dict, path: str, value: Any, *, create: bool = True) -> None:
    """Set a value at a dotted path, creating intermediate dicts if allowed."""
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        if isinstance(node, list):
            node = node[int(part)]
            continue
        if part not in node or node[part] is None:
            if not create:
                raise KeyError(path)
            node[part] = {}
        node = node[part]
        if not isinstance(node, (dict, list)):
            raise ConfigError(
                f"Cannot set '{path}': '{part}' is a leaf ({type(node).__name__})"
            )
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def delete_by_path(cfg: dict, path: str) -> None:
    parts = path.split(".")
    node = get_by_path(cfg, ".".join(parts[:-1])) if len(parts) > 1 else cfg
    if isinstance(node, dict) and parts[-1] in node:
        del node[parts[-1]]
    else:
        raise KeyError(path)


def _resolve_value(expr: str, root: Any) -> Any:
    expr = expr.strip()
    if expr.startswith("env:") or expr.startswith("oc.env:"):
        body = expr.split(":", 1)[1]
        if "," in body:
            var, default = body.split(",", 1)
            return os.environ.get(var.strip(), default.strip())
        val = os.environ.get(body.strip())
        if val is None:
            raise ConfigError(f"Environment variable '{body}' is not set")
        return val
    try:
        return get_by_path(root, expr)
    except (KeyError, IndexError, ValueError) as err:
        raise ConfigError(f"Could not resolve interpolation '${{{expr}}}'") from err


def resolve_interpolations(cfg: Any, root: Any | None = None, _depth: int = 0) -> Any:
    """Resolve ``${...}`` interpolations throughout the tree (returns new tree)."""
    if _depth > 16:
        raise ConfigError("Interpolation recursion limit exceeded (cycle?)")
    if root is None:
        root = cfg
    if isinstance(cfg, dict):
        return {k: resolve_interpolations(v, root, _depth) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [resolve_interpolations(v, root, _depth) for v in cfg]
    if isinstance(cfg, str) and "${" in cfg:
        full = _INTERP_RE.fullmatch(cfg)
        if full:  # whole-string interpolation preserves type
            val = _resolve_value(full.group(1), root)
            if isinstance(val, (dict, list)):
                # container value: deep-resolve its own interpolations and
                # COPY — the result must not alias the source subtree
                # (e.g. dataloader.val=${dataloader.train})
                return resolve_interpolations(
                    copy.deepcopy(val), root, _depth + 1
                )
            if isinstance(val, str) and "${" in val:
                val = resolve_interpolations(val, root, _depth + 1)
            return val
        def _sub(m: re.Match) -> str:
            return str(_resolve_value(m.group(1), root))
        out = _INTERP_RE.sub(_sub, cfg)
        if "${" in out:
            out = resolve_interpolations(out, root, _depth + 1)
        return out
    return cfg


def find_missing(cfg: Any, prefix: str = "") -> list[str]:
    """Return dotted paths of all values still equal to :data:`MISSING`."""
    found: list[str] = []
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            found.extend(find_missing(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(cfg, list):
        for i, v in enumerate(cfg):
            found.extend(find_missing(v, f"{prefix}.{i}" if prefix else str(i)))
    elif cfg == MISSING:
        found.append(prefix)
    return found
