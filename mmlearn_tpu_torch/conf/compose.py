"""Experiment composition: base schema + experiment YAML + CLI overrides.

The port's copy of :mod:`mmlearn_tpu.conf.compose`: it stands in for
Hydra's compose pipeline. The composition order matches Hydra's:

1. the base config schema (:func:`mmlearn_tpu_torch.conf.base_config`),
2. the experiment file's ``defaults`` list (group entries pulled from the
   :class:`~mmlearn_tpu_torch.conf.store.ConfigStore`),
3. the experiment file's own body,
4. CLI overrides, applied left to right,
5. interpolation resolution.

Override grammar (subset of Hydra's):

- ``a.b.c=value``      set a value (YAML-parsed);
- ``+a.b.c=value``     add a new value;
- ``~a.b.c``           delete a value;
- ``group=name`` / ``group@a.b=name``  insert a store node (also ``+``-form);
- ``+experiment=name`` compose an experiment file from the searchpath;
- ``searchpath=[pkg://pkg.mod,...]``  extend the config searchpath
  (``hydra.searchpath=...`` is accepted as an alias).
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path
from typing import Any, Sequence

import yaml

from mmlearn_tpu_torch.conf.config import (
    ConfigError,
    delete_by_path,
    get_by_path,
    merge,
    resolve_interpolations,
    set_by_path,
)
from mmlearn_tpu_torch.conf.store import store


def _parse_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def _searchpath_dir(entry: str) -> Path:
    if entry.startswith("pkg://"):
        module_path = entry[len("pkg://") :].replace("/", ".")
        module = importlib.import_module(module_path)
        file = getattr(module, "__file__", None)
        if file is None:
            raise ConfigError(f"Searchpath package '{module_path}' has no __file__")
        return Path(file).parent
    if entry.startswith("file://"):
        return Path(entry[len("file://") :])
    return Path(entry)


def _find_config_file(name: str, searchpath: Sequence[str], subdir: str) -> Path:
    candidates = []
    for entry in searchpath:
        base = _searchpath_dir(entry)
        candidates.extend(
            [
                base / subdir / f"{name}.yaml",
                base / subdir / f"{name}.yml",
                base / f"{name}.yaml",
                base / f"{name}.yml",
            ]
        )
    for path in candidates:
        if path.is_file():
            return path
    raise ConfigError(
        f"Config file '{name}' not found under {subdir!r} in searchpath "
        f"{list(searchpath)} (tried {[str(c) for c in candidates]})"
    )


def _load_yaml(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ConfigError(f"Config file {path} must contain a mapping")
    return data


def _apply_group_default(cfg: dict, group_spec: str, name: Any) -> dict:
    """Apply one defaults-list entry like ``/datasets@datasets.train: ImageNet``."""
    group = group_spec.lstrip("/")
    if "@" in group:
        group, target_path = group.split("@", 1)
    else:
        target_path = group.replace("/", ".")
        head = target_path.split(".", 1)[0]
        if head not in cfg:
            # Hydra's default-package semantics put the node at the group
            # path — for slash groups that lands outside the schema, which
            # nothing reads. Almost always a missing '@': say so loudly.
            import logging

            logging.getLogger(__name__).warning(
                "Group override '%s=%s' writes to cfg.%s, which is not "
                "part of the base schema and will be ignored by the run — "
                "did you mean '%s@<target.path>=%s'?",
                group_spec, name, target_path, group_spec, name,
            )
    if name is None:
        set_by_path(cfg, target_path, None)
        return cfg
    if isinstance(name, list):
        nodes = [store.get(group, n) for n in name]
        set_by_path(cfg, target_path, nodes)
        return cfg
    node = store.get(group, str(name))
    set_by_path(cfg, target_path, node)
    return cfg


def _apply_defaults_list(cfg: dict, defaults: list) -> dict:
    for entry in defaults:
        if entry == "_self_" or entry is None:
            continue
        if isinstance(entry, str):
            # bare "group: name" shorthand written as "group/name"
            if "/" in entry:
                group, name = entry.rsplit("/", 1)
                cfg = _apply_group_default(cfg, group, name)
                continue
            raise ConfigError(f"Unsupported defaults entry: {entry!r}")
        if isinstance(entry, dict):
            for group_spec, name in entry.items():
                cfg = _apply_group_default(cfg, str(group_spec), name)
            continue
        raise ConfigError(f"Unsupported defaults entry: {entry!r}")
    return cfg


def _compose_experiment(cfg: dict, name: str, searchpath: Sequence[str]) -> dict:
    path = _find_config_file(name, searchpath, subdir="experiment")
    body = _load_yaml(path)
    defaults = body.pop("defaults", [])
    cfg = _apply_defaults_list(cfg, defaults)
    return merge(cfg, body)


def _plain_override_allowed(cfg: dict, key: str) -> bool:
    """Whether a plain (non-'+') override may write ``key``.

    A path counts as existing when it fully resolves, OR when traversal
    stops at an existing key whose value is ``None`` — ``set_by_path``
    deliberately creates dicts through ``None`` placeholders (e.g.
    ``trainer.mesh_shape`` defaults to ``None``, docs/parallelism.md), so
    writing through one overrides an existing key rather than planting a
    typo'd new one.
    """
    node = cfg
    for part in key.split("."):
        if node is None:
            return True
        if isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return False
        elif isinstance(node, dict):
            if part not in node:
                return False
            node = node[part]
        else:
            return False
    return True


def _is_group_override(key: str) -> bool:
    group = key.lstrip("+~").split("@", 1)[0]
    return store.has_group(group)


def compose(
    base: dict,
    overrides: Sequence[str] = (),
    searchpath: Sequence[str] | None = None,
    resolve: bool = True,
) -> dict:
    """Compose a final config from a base schema + CLI-style overrides."""
    cfg = merge({}, base)
    sp: list[str] = list(searchpath or [])
    sp.append(str(Path(__file__).parent / "configs"))
    if os.environ.get("MMLEARN_SEARCHPATH"):
        sp.extend(os.environ["MMLEARN_SEARCHPATH"].split(","))

    # First pass: collect searchpath extensions so later experiment lookups
    # can see them regardless of argument order; hoist +experiment= entries
    # to the front so explicit CLI overrides ALWAYS win over the experiment
    # body regardless of argument order (Hydra semantics — an override
    # typed before +experiment must not be clobbered by the file).
    experiments: list[str] = []
    remaining: list[str] = []
    for ov in overrides:
        key = ov.split("=", 1)[0].strip()
        if key in ("searchpath", "hydra.searchpath", "+searchpath"):
            value = _parse_value(ov.split("=", 1)[1])
            entries = value if isinstance(value, list) else [value]
            sp = [str(e) for e in entries] + sp
        elif key in ("experiment", "+experiment"):
            experiments.append(ov)
        else:
            remaining.append(ov)

    for ov in experiments + remaining:
        if ov.startswith("~"):
            try:
                delete_by_path(cfg, ov[1:])
            except KeyError:
                raise ConfigError(f"Cannot delete non-existent key '{ov[1:]}'")
            continue
        if "=" not in ov:
            raise ConfigError(f"Malformed override '{ov}' (expected key=value)")
        key, raw_value = ov.split("=", 1)
        key = key.strip()
        additive = key.startswith("+")
        if additive:
            key = key[1:]
        if key == "experiment":
            cfg = _compose_experiment(cfg, raw_value.strip(), sp)
            continue
        if _is_group_override(key):
            group_spec = key
            cfg = _apply_group_default(cfg, group_spec, raw_value.strip())
            continue
        if not additive:
            # Hydra semantics: a plain override must target an existing key;
            # new keys need the '+' prefix. Without this check a typo
            # ('trainer.max_step=5') silently plants a dead config key.
            if not _plain_override_allowed(cfg, key):
                raise ConfigError(
                    f"Could not override '{key}': no such key in the "
                    f"composed config. Prefix with '+' (+{key}=...) to add "
                    "a new key."
                ) from None
        set_by_path(cfg, key, _parse_value(raw_value), create=True)

    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg
