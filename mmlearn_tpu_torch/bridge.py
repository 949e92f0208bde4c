"""Weights across the two packages: JAX parameter paths to the port's
``state_dict`` and back.

The JAX package's parameters are a nested dict (``jax.device_get`` of the
tree gives numpy leaves); flattened, each leaf has a path such as
``blocks_3/attn/qkv/kernel``. The port names its modules after the flax
modules, so a path maps to a ``state_dict`` key by four rules:

- blocks: the scanned stack ``block_stack/blocks/block/<rest>`` holds every
  layer along a leading depth axis and unstacks to ``blocks.{i}.<rest>``;
  per-layer ``blocks_{i}/<rest>`` maps to the same key;
- Dense ``kernel`` ``(in, out)`` is the transpose of Linear ``weight``;
- the patch conv's HWIO ``kernel`` ``(kh, kw, cin, out)`` becomes
  ``(out, kh, kw, cin)``;
- LayerNorm ``scale`` and Embed ``embedding`` are named ``weight``.

The reverse (:func:`torch_to_jax`) writes the per-layer ``blocks_{i}``
layout. Plain numpy and torch: nothing here imports jax.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.modules.encoders.text import Embed
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.embedding import PatchProj
from mmlearn_tpu_torch.modules.layers.normalization import AffineNorm

_SCANNED = "block_stack/blocks/block/"
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays to ``{"a/b/c": array}``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, f"{path}/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _to_state(out: dict[str, torch.Tensor], path: str, arr: np.ndarray) -> None:
    *modules, leaf = path.split("/")
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 0, 1, 2)
        else:
            raise ValueError(f"{path}: a kernel must be 2-D or 4-D, got {arr.shape}")
    key = ".".join([*modules, _RENAME.get(leaf, leaf)])
    out[key] = torch.from_numpy(np.array(arr, order="C"))  # writable copy


def jax_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX parameter tree (nested, or flat with ``/`` paths) as a
    ``state_dict`` of the port's counterpart module."""
    flat = flatten(params)
    out: dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        if _SCANNED in path:
            head, rest = path.split(_SCANNED, 1)
            for i in range(arr.shape[0]):
                _to_state(out, f"{head}blocks/{i}/{rest}", arr[i])
        else:
            _to_state(out, re.sub(r"(^|/)blocks_(\d+)/", r"\1blocks/\2/", path), arr)
    return out


def torch_to_jax(module: nn.Module) -> dict[str, np.ndarray]:
    """A port module's parameters as flat JAX paths (per-layer blocks)."""
    flat: dict[str, np.ndarray] = {}
    for name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            arr = p.detach().cpu().numpy()
            leaf = pname
            if pname == "weight":
                if isinstance(mod, Dense):
                    leaf, arr = "kernel", arr.T
                elif isinstance(mod, PatchProj):
                    leaf, arr = "kernel", arr.transpose(1, 2, 3, 0)
                elif isinstance(mod, AffineNorm):
                    leaf = "scale"
                elif isinstance(mod, Embed):
                    leaf = "embedding"
            path = re.sub(r"(^|\.)blocks\.(\d+)(?=\.|$)", r"\1blocks_\2", name)
            flat["/".join([*filter(None, path.split(".")), leaf])] = (
                np.ascontiguousarray(arr)
            )
    return flat


def save_npz(path: str, flat: Mapping[str, np.ndarray]) -> None:
    """Write flat ``{"a/b/c": array}`` weights to one ``.npz``."""
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Read weights written by :func:`save_npz`."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
