"""Encoder serving artifacts, counterpart of :mod:`mmlearn_tpu.serving.export`.

An artifact directory holds:

- ``encoder.<platform>.pt2`` -- one ``torch.export`` program a platform
  (``cuda``, ``cpu``): ``fn(params, batch) -> embeddings``, the task's
  ``encode`` of one modality (the encoder, its postprocessor and head, the
  L2 norm where ``normalized``), batch-polymorphic over the leading
  dimension (a ``Dim`` from 1 up). Each platform has its own program, since
  a trace fixes the device of the tensors it creates. Where the encode runs
  a hand-written kernel, the program calls its registered operator
  (:mod:`mmlearn_tpu_torch.ops.registered`), which launches the kernel on a
  CUDA tensor and runs its plain version on a CPU one;
- ``weights.npz`` -- the parameters the encode reads, flat and keyed by the
  JAX package's paths (:mod:`mmlearn_tpu_torch.bridge`) below the deepest
  module that holds them all: the encoder's own paths (the JAX
  ``params["encoders"][modality]``) for a tower without a head or
  postprocessor, ``encoders/...`` and ``heads/...`` with one. A LoRA'd
  layer's weight is its merged one, and the program computes with it as a
  plain layer, so the artifact computes what the tower computes in the task;
- ``program.json`` -- the program's parameters in call order: each one's
  name in the program, its path in ``weights.npz`` and the axes that take
  the port's layout to the JAX one;
- ``meta.json`` -- the keys of the JAX artifact: ``modality``,
  ``normalized``, ``embedding_dim``, ``platforms`` (those exported) and
  ``inputs`` (the feed contract: exactly the batch keys the encoder
  consumes, with shape and dtype; the leading batch dimension is free).

:func:`load_encoder` needs torch, numpy and the registered operators: no
encoder class, task, ``bridge`` or ``peft``, so a serving host runs the
artifact without the port's model code.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

PROGRAM = "encoder.{}.pt2"
SIGNATURE = "program.json"
WEIGHTS = "weights.npz"
META = "meta.json"


def _encoder_input_keys(modality: str, example_batch: Mapping[str, Any]) -> list[str]:
    """The batch keys the encoder consumes (its input and padding mask)."""
    from mmlearn_tpu_torch.datasets.core.modalities import Modalities

    mod = Modalities.get_modality(modality)
    keys = [k for k in (mod.name, mod.attention_mask) if k in example_batch]
    if not keys:
        raise ValueError(f"example_batch has no '{mod.name}' input for modality {modality}")
    return keys


def _host(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=name)).dtype


class _Encode(nn.Module):
    """``task.encode(batch, modality, normalize)`` as a module's forward,
    for ``torch.func.functional_call``."""

    def __init__(self, task: nn.Module, modality: str, normalize: bool) -> None:
        super().__init__()
        self.task = task
        self.modality = modality
        self.normalize = normalize

    def forward(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.task.encode(batch, self.modality, normalize=self.normalize)


class _Program(nn.Module):
    """What is traced: the encode with the parameters it reads as inputs.
    The task is held outside the module tree, so that none of its tensors is
    lifted into the program as a parameter; ``constants`` stand in for every
    other tensor of the task (its buffers, and parameters the encode does
    not read), on the program's device. The buffers the encode reads go into
    the program as constants."""

    def __init__(self, encode: _Encode, constants: dict[str, torch.Tensor]) -> None:
        super().__init__()
        self._held = (encode, constants)

    def forward(self, params: dict[str, torch.Tensor],
                batch: dict[str, torch.Tensor]) -> torch.Tensor:
        encode, constants = self._held
        tensors = {f"task.{k}": v for k, v in {**constants, **params}.items()}
        return torch.func.functional_call(encode, tensors, (batch,))


class _Reads(torch.overrides.TorchFunctionMode):
    """Records which of ``tensors`` an operation takes (reading an attribute
    such as ``.device`` is not taking it)."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        self._names = {id(t): n for n, t in tensors.items()}
        self.read: set[str] = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) == "__get__":
            return func(*args, **kwargs)
        for leaf in torch.utils._pytree.tree_leaves((args, kwargs)):
            name = self._names.get(id(leaf))
            if name is not None:
                self.read.add(name)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _merged_lora(task: nn.Module):
    """The task with each LoRA'd layer's factors detached, for as long as the
    context lasts; yields ``{parameter name: merged weight}`` to compute
    with in their place."""
    layers = [(name, mod) for name, mod in task.named_modules() if "lora" in mod.__dict__]
    merged = {f"{name}.weight" if name else "weight": mod.merged_weight().detach()
              for name, mod in layers}
    detached = [(mod, mod.__dict__.pop("lora")) for _, mod in layers]
    try:
        yield merged
    finally:
        for mod, lora in detached:
            mod.__dict__["lora"] = lora


def _common_module(names: Sequence[str]) -> str:
    """The deepest module that holds every parameter of ``names``."""
    parts = [n.split(".")[:-1] for n in names]
    common: list[str] = []
    for level in zip(*parts):
        if len(set(level)) != 1:
            break
        common.append(level[0])
    return ".".join(common)


def export_encoder(
    task: nn.Module,
    modality: str,
    example_batch: Mapping[str, Any],
    normalize: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> tuple[dict[str, Any], dict[str, np.ndarray], dict[str, Any], dict[str, Any]]:
    """Trace ``task.encode`` of ``modality`` with ``torch.export``, once a
    platform.

    Args:
        task: any task with ``encode(batch, modality, normalize=)``
            (``ContrastivePretraining`` with heads and postprocessors,
            ``IJEPA``), with any encoder.
        modality: the tower to export.
        example_batch: a batch holding the modality's input keys; their
            shapes and dtypes are read, and one row is encoded to find the
            parameters the encode reads.
        normalize: the L2 norm in the program.
        platforms: ``"cuda"`` and/or ``"cpu"``; by default both where a
            card is present, else ``("cpu",)``.

    Returns ``(programs, weights, signature, meta)``: the
    ``torch.export.ExportedProgram`` of each platform, the weights by JAX
    path, the program's parameters (``program.json``) and ``meta.json``.
    """
    from mmlearn_tpu_torch import bridge

    modality = str(modality).lower()
    if platforms is None:
        platforms = ("cuda", "cpu") if torch.cuda.is_available() else ("cpu",)
    keys = _encoder_input_keys(modality, example_batch)
    feed = {k: _host(example_batch[k]) for k in keys}
    # the trace's example has two rows or more: a size of 1 would be
    # specialized
    trace_feed = {k: np.concatenate([v, v]) if len(v) < 2 else v for k, v in feed.items()}
    device = next(task.parameters()).device
    training = task.training
    task.eval()
    try:
        with _merged_lora(task) as merged:
            params = {n: merged.get(n, p.detach()) for n, p in task.named_parameters()}
            buffers = dict(task.named_buffers())
            encode = _Encode(task, modality, normalize)
            with torch.no_grad(), _Reads(params) as reads:
                probe = torch.func.functional_call(
                    encode, {f"task.{k}": v for k, v in {**buffers, **params}.items()},
                    ({k: torch.as_tensor(v[:1], device=device) for k, v in feed.items()},))
            used = [n for n in params if n in reads.read]
            programs = {}
            for platform in platforms:
                dev = torch.device(platform)

                def on(t: torch.Tensor, keep: bool = False) -> torch.Tensor:
                    # values where the trace reads them (buffers), else only
                    # the shape on the platform's device
                    if t.device == dev:
                        return t
                    return t.to(dev) if keep else torch.empty_like(t, device=dev)

                constants = {**{n: on(p) for n, p in params.items() if n not in used},
                             **{n: on(b, keep=True) for n, b in buffers.items()}}
                inputs = {n: on(params[n]) for n in used}
                batch = {k: torch.as_tensor(v, device=dev) for k, v in trace_feed.items()}
                dim = torch.export.Dim("batch", min=1)
                with torch.no_grad():
                    programs[platform] = torch.export.export(
                        _Program(encode, constants), (inputs, batch),
                        dynamic_shapes=({n: None for n in used}, {k: {0: dim} for k in keys}),
                        strict=False)
    finally:
        task.train(training)

    leaves = bridge.jax_leaves(task)
    root = bridge.jax_module_path(_common_module(used))
    weights, signature = {}, {"params": [], "inputs": keys}
    for name in used:
        path, axes = leaves[name]
        if root:
            path = path[len(root) + 1:]
        t = params[name].detach()  # numpy has no bf16: such a weight is kept in f32
        arr = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        weights[path] = np.ascontiguousarray(arr if axes is None else arr.transpose(axes))
        signature["params"].append({"name": name, "path": path,
                                    "axes": None if axes is None else list(axes),
                                    "dtype": str(params[name].dtype).removeprefix("torch.")})
    meta = {
        "modality": modality,
        "normalized": bool(normalize),
        "embedding_dim": int(probe.shape[-1]),
        "platforms": list(platforms),
        "inputs": {k: {"shape": list(feed[k].shape), "dtype": str(feed[k].dtype)} for k in keys},
    }
    return programs, weights, signature, meta


def save_encoder(
    output_dir: str,
    task: nn.Module,
    modality: str,
    example_batch: Mapping[str, Any],
    normalize: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> str:
    """Export (:func:`export_encoder`) and write the artifact directory.
    Returns ``output_dir``."""
    programs, weights, signature, meta = export_encoder(
        task, modality, example_batch, normalize=normalize, platforms=platforms)
    os.makedirs(output_dir, exist_ok=True)
    for platform, program in programs.items():
        program.example_inputs = None  # the trace's inputs hold every weight: not kept
        torch.export.save(program, os.path.join(output_dir, PROGRAM.format(platform)))
    with open(os.path.join(output_dir, WEIGHTS), "wb") as f:
        np.savez(f, **weights)
    for name, content in ((SIGNATURE, signature), (META, meta)):
        with open(os.path.join(output_dir, name), "w") as f:
            json.dump(content, f, indent=2)
    return output_dir


def load_encoder(
    artifact_dir: str, device: torch.device | str = "cuda"
) -> Callable[[Mapping[str, Any]], torch.Tensor]:
    """Load an artifact's program for ``device`` as ``fn(batch) ->
    embeddings``.

    Raises where the artifact holds no program for the device's platform: a
    CPU program never runs on the card. The batch's inputs (numpy arrays or
    tensors) are cast to the dtypes of ``meta.json`` and put on ``device``.
    The returned function carries ``meta`` (the artifact's ``meta.json``)
    and ``program`` (the loaded program's module).
    """
    from mmlearn_tpu_torch.ops import registered  # noqa: F401 - the operators the program calls

    device = torch.device(device)
    with open(os.path.join(artifact_dir, META)) as f:
        meta = json.load(f)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{artifact_dir} holds no {device.type} program (platforms "
                         f"{meta['platforms']}); export it with platforms=("
                         f"'{device.type}', ...)")
    with open(os.path.join(artifact_dir, SIGNATURE)) as f:
        signature = json.load(f)
    program = torch.export.load(
        os.path.join(artifact_dir, PROGRAM.format(device.type))).module()
    params = {}
    with np.load(os.path.join(artifact_dir, WEIGHTS)) as z:
        for p in signature["params"]:
            arr = z[p["path"]]
            if p["axes"] is not None:
                arr = arr.transpose(np.argsort(p["axes"]))
            params[p["name"]] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=getattr(torch, p["dtype"]))
    dtypes = {k: _torch_dtype(v["dtype"]) for k, v in meta["inputs"].items()}

    def encode(batch: Mapping[str, Any]) -> torch.Tensor:
        inputs = {k: (batch[k] if isinstance(batch[k], torch.Tensor)
                      else torch.as_tensor(np.asarray(batch[k]))).to(device=device, dtype=dt)
                  for k, dt in dtypes.items()}
        with torch.inference_mode():
            return program(params, inputs)

    encode.meta = meta  # type: ignore[attr-defined]
    encode.program = program  # type: ignore[attr-defined]
    return encode
