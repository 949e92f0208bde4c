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
- a conv's HWIO ``kernel`` ``(kh, kw, cin, out)`` (the patch embedding's,
  ``ConvEmbed``'s) becomes ``(out, kh, kw, cin)``;
- LayerNorm ``scale`` and Embed ``embedding`` (the token and token-type
  tables) are named ``weight``.

Other leaves keep their names: biases, ``pos_embed``, ``cls_token``,
``log_logit_scale``. A patch embedding or projection without a bias has
none on either side. A block under ``nn.remat`` keeps its path (flax names
the wrapped module as given: ``blocks_{i}``, or ``block`` in the scanned
body). The reverse (:func:`torch_to_jax`) writes the per-layer
``blocks_{i}`` layout, or with ``scanned=True`` the scanned stack's. An
I-JEPA task's trees (``params = {"encoder", "predictor"}`` and
the teacher in ``extras["ema_encoder"]``) cross with
:func:`ijepa_jax_to_torch` and :func:`ijepa_torch_to_jax` (the EMA step
offset, ``extras["ema_step_offset"]``, as the task's ``_extra_state``). A
contrastive task with auxiliary tasks (``params["aux"][name]["predictor"]``,
``extras[name]["ema_encoder"]`` and ``extras[name]["ema_step_offset"]``)
crosses with :func:`task_jax_to_torch` and :func:`task_torch_to_jax`:
``auxiliary_tasks.<name>.predictor``, ``.teacher`` and ``._extra_state``
in the port. A whole JAX
train state, with its AdamW moments, schedule position and accumulated
gradient, becomes a port checkpoint with :func:`train_state_from_jax`.
The towers of the BIOSCAN-CLIP recipe (``BertTextEncoder``, ``BarcodeBERT``
with its ``bert`` trunk) follow the same rules, and so does a contrastive
task's LoRA tree: ``lora/<encoder>/<layer path>/{a, b}`` (or
``.../{q, v}/{a, b}`` per qkv slice) is ``lora.<encoder>.<layer>.a`` in the
port, the factors untransposed (``a`` ``(in, r)``, ``b`` ``(r, out)`` on
both sides). :func:`jax_paths` names each port parameter's JAX path.
Plain numpy and torch: nothing here imports jax.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.modules.encoders.text import Embed
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.embedding import Conv, PatchProj
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


def jax_module_path(name: str) -> str:
    """A port module's dotted name as its JAX path: ``blocks.3.attn.qkv`` to
    ``blocks_3/attn/qkv``."""
    return "/".join(filter(None, re.sub(r"(^|\.)blocks\.(\d+)(?=\.|$)", r"\1blocks_\2",
                                        name).split(".")))


def _jax_leaf(mod: nn.Module, pname: str) -> tuple[str, Optional[tuple[int, ...]]]:
    """A parameter's JAX leaf name, and the axes that take it to the JAX
    layout (``None``: as it is)."""
    if pname == "weight":
        if isinstance(mod, Dense):
            return "kernel", (1, 0)
        if isinstance(mod, (PatchProj, Conv)):
            return "kernel", (1, 2, 3, 0)
        if isinstance(mod, AffineNorm):
            return "scale", None
        if isinstance(mod, Embed):
            return "embedding", None
    return pname, None


def jax_leaves(module: nn.Module) -> dict[str, tuple[str, Optional[tuple[int, ...]]]]:
    """``{parameter name: (JAX path, axes)}`` of every parameter of
    ``module``: ``blocks.3.attn.qkv.weight`` to ``("blocks_3/attn/qkv/kernel",
    (1, 0))``, the axes taking the port's layout to the JAX one (``None``: as
    it is)."""
    out = {}
    for name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            leaf, axes = _jax_leaf(mod, pname)
            out[f"{name}.{pname}" if name else pname] = (
                "/".join(filter(None, [jax_module_path(name), leaf])), axes)
    return out


def jax_paths(module: nn.Module) -> dict[str, str]:
    """``{parameter name: JAX path}`` of every parameter of ``module``:
    ``blocks.3.attn.qkv.weight`` to ``blocks_3/attn/qkv/kernel``."""
    return {name: path for name, (path, _) in jax_leaves(module).items()}


def torch_to_jax(module: nn.Module, scanned: bool = False,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> dict[str, np.ndarray]:
    """A port module's parameters as flat JAX paths: per-layer blocks
    (``blocks_{i}/...``), or with ``scanned`` each stack's blocks stacked
    along a leading depth axis under ``block_stack/blocks/block/...``, the
    layout of a tower built with ``scan_blocks=True``. ``state_dict``: the
    values to write, by parameter name, in place of the parameters' own
    (a LoRA'd tower's merged weights)."""
    flat: dict[str, np.ndarray] = {}
    for name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if state_dict is not None:
                p = state_dict[f"{name}.{pname}" if name else pname]
            leaf, axes = _jax_leaf(mod, pname)
            arr = _whole(p.detach()).cpu().numpy()
            flat["/".join(filter(None, [jax_module_path(name), leaf]))] = (
                np.ascontiguousarray(arr if axes is None else arr.transpose(axes))
            )
    return _stack_blocks(flat) if scanned else flat


def _whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor (a task split over ``model`` and sharded by
    FSDP2) gathered from its shards, a collective every rank of its mesh
    makes in the same order; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def load_state(module: nn.Module, state: Mapping[str, Any]) -> None:
    """Load a whole ``state_dict`` (the JAX parameters through
    :func:`jax_to_torch`, or a one-device checkpoint's) into ``module``,
    strictly. Into a parallelized task (split over ``model``, sharded by
    FSDP2) through ``set_model_state_dict`` with the full state dict: each
    rank keeps its shares of the whole tensors it is given."""
    if any(hasattr(p, "placements") for p in module.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
        )

        set_model_state_dict(module, dict(state),
                             options=StateDictOptions(full_state_dict=True, strict=True))
    else:
        module.load_state_dict(dict(state), strict=True)


def _stack_blocks(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Per-layer ``<head>blocks_{i}/<rest>`` leaves stacked in block order
    into ``<head>block_stack/blocks/block/<rest>``."""
    out: dict[str, np.ndarray] = {}
    layers: dict[tuple[str, str], dict[int, np.ndarray]] = {}
    for path, arr in flat.items():
        m = re.match(r"^(.*?)blocks_(\d+)/(.*)$", path)
        if m is None:
            out[path] = arr
        else:
            layers.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = arr
    for (head, rest), by_layer in layers.items():
        out[f"{head}{_SCANNED}{rest}"] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def ijepa_jax_to_torch(
    params: Mapping[str, Any], extras: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """A JAX I-JEPA task's ``params`` (``encoder`` and ``predictor``) and
    ``extras["ema_encoder"]``, nested or as flat ``/`` paths, as the
    ``state_dict`` of the port's ``IJEPA``: ``encoder.*``, ``predictor.*``
    and ``teacher.*``. Without a teacher in the extras the teacher is the
    student, as the JAX task's loss takes it."""
    flat = flatten(params)
    teacher = {k.removeprefix("ema_encoder/"): v for k, v in flatten(extras or {}).items()
               if k.startswith("ema_encoder/")}
    if not teacher:
        teacher = {k.removeprefix("encoder/"): v for k, v in flat.items()
                   if k.startswith("encoder/")}
    flat.update({f"teacher/{k}": v for k, v in teacher.items()})
    out: dict[str, Any] = jax_to_torch(flat)
    out["_extra_state"] = {"ema_step_offset": int(np.asarray((extras or {}).get(
        "ema_step_offset", 0)))}
    return out


def ijepa_torch_to_jax(task: nn.Module) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The port's ``IJEPA`` as flat JAX paths: ``(params, extras)``, the
    student under ``encoder/`` and the predictor under ``predictor/`` in
    ``params``, the teacher under ``ema_encoder/`` in ``extras``."""
    params, extras = {}, {}
    for path, arr in torch_to_jax(task).items():
        if path.startswith("teacher/"):
            extras["ema_encoder/" + path.removeprefix("teacher/")] = arr
        else:
            params[path] = arr
    return params, extras


def task_jax_to_torch(
    params: Mapping[str, Any], extras: Mapping[str, Any] | None = None
) -> dict[str, Any]:
    """A JAX ``ContrastivePretraining``'s ``params`` and ``extras``, nested
    or as flat ``/`` paths, as the port task's ``state_dict``: each
    auxiliary task's ``params["aux"][name]["predictor"]``,
    ``extras[name]["ema_encoder"]`` (the teacher) and
    ``extras[name]["ema_step_offset"]`` under ``auxiliary_tasks.<name>``."""
    flat, flat_extras = flatten(params), flatten(extras or {})
    names = {k.split("/")[1] for k in flat if k.startswith("aux/")}
    names |= {k.split("/")[0] for k in flat_extras}
    flat = {re.sub(r"^aux/", "auxiliary_tasks/", k): v for k, v in flat.items()}
    extra_states = {}
    for name in names:
        mine = {k.removeprefix(f"{name}/"): v for k, v in flat_extras.items()
                if k.startswith(f"{name}/")}
        for k, v in mine.items():
            if k.startswith("ema_encoder/"):
                flat[f"auxiliary_tasks/{name}/teacher/{k.removeprefix('ema_encoder/')}"] = v
        extra_states[f"auxiliary_tasks.{name}._extra_state"] = {
            "ema_step_offset": int(np.asarray(mine.get("ema_step_offset", 0)))}
    out: dict[str, Any] = jax_to_torch(flat)
    out.update(extra_states)
    return out


def task_torch_to_jax(task: nn.Module) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """The port's ``ContrastivePretraining`` as flat JAX paths: ``(params,
    extras)``, an auxiliary task's predictor under ``aux/<name>/predictor/``
    in ``params``, its teacher under ``<name>/ema_encoder/`` and its EMA
    step offset under ``<name>/ema_step_offset`` in ``extras``."""
    params: dict[str, np.ndarray] = {}
    extras: dict[str, Any] = {}
    for path, arr in torch_to_jax(task).items():
        m = re.match(r"^auxiliary_tasks/([^/]+)/(.*)$", path)
        if m is None:
            params[path] = arr
        elif m.group(2).startswith("teacher/"):
            extras[f"{m.group(1)}/ema_encoder/{m.group(2).removeprefix('teacher/')}"] = arr
        else:
            params[f"aux/{m.group(1)}/{m.group(2)}"] = arr
    for name, aux in getattr(task, "auxiliary_tasks", {}).items():
        extras[f"{name}/ema_step_offset"] = np.asarray(aux.ema_step_offset, np.int32)
    return params, extras


def save_npz(path: str, flat: Mapping[str, np.ndarray]) -> None:
    """Write flat ``{"a/b/c": array}`` weights to one ``.npz``."""
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Read weights written by :func:`save_npz`."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _find_state(tree: Any, fields: tuple[str, ...]) -> Any:
    """The first optax state (a named tuple) in ``tree`` with ``fields``."""
    if hasattr(tree, "_fields") and all(f in tree._fields for f in fields):
        return tree
    if isinstance(tree, Mapping):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _find_state(item, fields)
            if found is not None:
                return found
    return None


def _tree_to_torch(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """:func:`jax_to_torch` of a tree shaped as a task's parameters, its
    ``aux/`` subtrees under the port's ``auxiliary_tasks``."""
    return jax_to_torch({re.sub(r"^aux/", "auxiliary_tasks/", k): v
                         for k, v in flatten(tree).items()})


def train_state_from_jax(state: Any) -> dict[str, Any]:
    """A JAX package's ``TrainState`` (``jax.device_get`` of it: numpy
    leaves) as the port's checkpoint state, for
    :meth:`mmlearn_tpu_torch.trainer.TrainState.load_state_dict` or a
    checkpoint directory that ``Trainer.fit(ckpt_path=...)`` resumes.

    - the weights: :func:`task_jax_to_torch` of ``params`` and ``extras``
      (auxiliary tasks' predictors and teachers included), or
      :func:`ijepa_jax_to_torch` with the teacher where ``extras`` holds
      ``ema_encoder``;
    - optax AdamW's ``count``, ``mu`` and ``nu`` (``ScaleByAdamState``) as
      ``torch.optim.AdamW``'s per-parameter ``step``, ``exp_avg`` and
      ``exp_avg_sq``, mapped by the same rules as the weights (a kernel's
      moments transposed with it); the optimizer's parameter groups (the
      decay mask's two) are the port task's own;
    - the schedule's position: ``count`` optimizer steps;
    - under ``optax.MultiSteps``, the running mean ``acc_grads`` of a window
      not yet applied (``mini_step > 0``);
    - ``step``, the micro-steps taken.
    """
    extras = state.extras or {}
    if any(k.startswith("ema_encoder/") for k in flatten(extras)):
        weights = ijepa_jax_to_torch(state.params, extras)
    else:
        weights = task_jax_to_torch(state.params, extras)
    adam = _find_state(state.opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("the JAX optimizer state holds no AdamW moments (ScaleByAdamState)")
    count = int(np.asarray(adam.count))
    mu, nu = _tree_to_torch(adam.mu), _tree_to_torch(adam.nu)
    moments = {name: {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                      "exp_avg_sq": nu[name]} for name in mu}
    multi = _find_state(state.opt_state, ("mini_step", "acc_grads"))
    accumulated = {}
    if multi is not None and int(np.asarray(multi.mini_step)) > 0:
        accumulated = _tree_to_torch(multi.acc_grads)
    return {
        "step": int(np.asarray(state.step)),
        "task": weights,
        "optimizer": {"state": moments, "param_groups": None},
        "lr_scheduler": {"last_epoch": count, "_step_count": count + 1},
        "accumulated": accumulated,
    }
