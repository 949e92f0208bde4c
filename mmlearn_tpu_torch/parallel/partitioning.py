"""Parameter partitioning by name, and its application with FSDP2,
counterpart of :mod:`mmlearn_tpu.parallel.partitioning`.

:func:`infer_param_specs` runs the JAX package's rules (:data:`DEFAULT_RULES`,
first match wins, then the fallback: the largest dim divisible by ``fsdp`` for
a parameter of at least ``min_shard_size`` elements, else replicated) on each
parameter's JAX path and JAX layout (:func:`~mmlearn_tpu_torch.bridge.jax_paths`:
a Linear ``weight`` is the transposed ``kernel``), and returns each spec in
the port's dims: ``{name: (axis or None, ...)}`` a dim of the tensor.

:func:`shard_task` applies them with FSDP2 ``fully_shard`` over the 2-D
``(data, fsdp)`` sub-mesh: replicated over ``data``, sharded over ``fsdp`` on
the dim the spec puts ``fsdp`` on. Each transformer block is wrapped, then
each tower (an encoder, a head, an I-JEPA predictor or teacher), then the
task, so one wrapper serves every world size, 1 included. FSDP2 manages every
parameter of at least one dim: one that the JAX rules replicate is sharded
on dim 0 (FSDP2 shards whatever it manages), and gathered before use like
the rest, so the values a step computes with are the same. FSDP2 takes no
0-d parameter (the logit scale): those stay plain, replicated tensors, whose
gradients :func:`sync_replicated_grads` averages over the ranks as FSDP2
averages the rest. PyTorch's AdamW takes its per-tensor loop over DTensor
parameters (its multi-tensor kernels take plain tensors only).

The specs' ``model`` entries are applied first, where ``model > 1``: each
layer whose spec puts ``model`` on a dim is split column- or row-wise over
the ``model`` sub-mesh (:func:`~mmlearn_tpu_torch.parallel.tensor_parallel.parallelize`),
then FSDP2 shards every parameter over ``(data, fsdp)`` as above: a split
weight ends as a ``DTensor`` over ``(data, fsdp, model)``, sharded over
``fsdp`` and ``model`` on the dims its spec names, replicated over ``data``.

The task's own methods that run towers (``loss_fn``, ``validation_loss``,
``encode``) are registered with FSDP2, so calling them gathers the task's
own parameters (the logit scale, LoRA factors) as ``forward`` does.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
from torch import nn

from mmlearn_tpu_torch.parallel.mesh import FSDP_AXIS, MODEL_AXIS, Mesh

# (path regex, ndim, spec) -- the JAX package's rules, specs as tuples of an
# axis name (or None) a dim of the JAX layout
DEFAULT_RULES: tuple[tuple[str, int, tuple], ...] = (
    (r".*/(attn|attention)/(query|key|value|qkv)/kernel$", 2, (FSDP_AXIS, MODEL_AXIS)),
    (r".*/(attn|attention)/(out|proj|out_proj)/kernel$", 2, (MODEL_AXIS, FSDP_AXIS)),
    (r".*/(attn|attention)/(query|key|value|qkv)/kernel$", 3, (None, FSDP_AXIS, MODEL_AXIS)),
    (r".*/(attn|attention)/(out|proj|out_proj)/kernel$", 3, (None, MODEL_AXIS, FSDP_AXIS)),
    (r".*/mlp/(fc1|up|gate|linear_0)/kernel$", 2, (FSDP_AXIS, MODEL_AXIS)),
    (r".*/mlp/(fc2|down|linear_1)/kernel$", 2, (MODEL_AXIS, FSDP_AXIS)),
    (r".*/mlp/(fc1|up|gate|linear_0)/kernel$", 3, (None, FSDP_AXIS, MODEL_AXIS)),
    (r".*/mlp/(fc2|down|linear_1)/kernel$", 3, (None, MODEL_AXIS, FSDP_AXIS)),
    (r".*embed.*/kernel$", 2, (None, FSDP_AXIS)),
    (r".*embedding$", 2, (None, FSDP_AXIS)),
)


def _spec_fits(shape: tuple, spec: tuple, mesh: Mesh) -> bool:
    if len(spec) > len(shape):
        return False
    return all(axis is None or dim % mesh.shape.get(axis, 1) == 0
               for dim, axis in zip(shape, spec))


def _fallback_spec(shape: tuple, mesh: Mesh) -> tuple:
    """The largest dim divisible by the fsdp axis; else replicated."""
    fsdp = mesh.shape[FSDP_AXIS]
    if fsdp == 1 or len(shape) == 0:
        return ()
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % fsdp == 0 and shape[i] >= fsdp:
            return tuple(FSDP_AXIS if j == i else None for j in range(len(shape)))
    return ()


def jax_spec(path: str, shape: tuple, mesh: Mesh,
             rules: Sequence[tuple[str, int, tuple]] = DEFAULT_RULES,
             min_shard_size: int = 2**14) -> tuple:
    """The JAX spec of the leaf at ``path`` (``/``-joined, JAX layout
    ``shape``): the JAX ``infer_param_specs`` for one leaf."""
    key = path.lower()
    for pattern, ndim, spec in rules:
        if len(shape) == ndim and re.match(pattern, "/" + key):
            if _spec_fits(shape, spec, mesh):
                return spec
            break
    if int(np.prod(shape)) >= min_shard_size:
        return _fallback_spec(shape, mesh)
    return ()


def _layouts(module: nn.Module) -> dict[str, tuple[str, Optional[tuple[int, ...]]]]:
    from mmlearn_tpu_torch.bridge import _jax_leaf, jax_module_path

    out = {}
    for name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            leaf, axes = _jax_leaf(mod, pname)
            out[f"{name}.{pname}" if name else pname] = (
                "/".join(filter(None, [jax_module_path(name), leaf])), axes)
    return out


def infer_param_specs(module: nn.Module, mesh: Mesh,
                      rules: Sequence[tuple[str, int, tuple]] = DEFAULT_RULES,
                      min_shard_size: int = 2**14) -> dict[str, tuple]:
    """``{parameter name: spec}``, the spec a tuple of an axis name (or
    ``None``) for each dim of the port's tensor; ``()`` is replicated."""
    params = dict(module.named_parameters())
    specs = {}
    for name, (path, axes) in _layouts(module).items():
        shape = tuple(params[name].shape)
        jax_shape = shape if axes is None else tuple(shape[a] for a in axes)
        spec = jax_spec(path, jax_shape, mesh, rules, min_shard_size)
        if spec and axes is not None:
            # JAX dim i is the port's dim axes[i]
            mine = [None] * len(shape)
            for i, axis in enumerate(spec):
                mine[axes[i]] = axis
            spec = tuple(mine)
        specs[name] = tuple(spec) + (None,) * (len(shape) - len(spec)) if spec else ()
    return specs


def shard_dim(spec: tuple) -> int:
    """The dim FSDP2 shards a parameter on: the spec's ``fsdp`` dim, else 0."""
    return spec.index(FSDP_AXIS) if FSDP_AXIS in spec else 0


def _units(task: nn.Module) -> list[nn.Module]:
    """The task's transformer blocks and towers, deepest first (FSDP2 wraps
    a module's children before the module)."""
    from mmlearn_tpu_torch.modules.encoders.bert import BertBlock, BertTextEncoder
    from mmlearn_tpu_torch.modules.encoders.text import TextTransformer
    from mmlearn_tpu_torch.modules.encoders.vision import (
        VisionTransformer,
        VisionTransformerPredictor,
    )
    from mmlearn_tpu_torch.modules.layers.transformer_block import Block

    tower_types = (VisionTransformer, VisionTransformerPredictor, TextTransformer,
                   BertTextEncoder)
    modules = dict(task.named_modules())
    units = []
    for name, mod in modules.items():
        if mod is task:
            continue
        parent = name.rsplit(".", 1)[0] if "." in name else ""
        held = parent.split(".")[-1] in ("encoders", "heads") and isinstance(
            modules[parent], nn.ModuleDict)
        if isinstance(mod, (Block, BertBlock)) or (
                (isinstance(mod, tower_types) or held)
                and any(p.numel() for p in mod.parameters())):
            units.append((name.count("."), mod))
    return [mod for _, mod in sorted(units, key=lambda u: -u[0])]


#: the task methods that run towers, registered with FSDP2 like ``forward``
TASK_METHODS = ("loss_fn", "validation_loss", "encode")


def shard_task(task: nn.Module, mesh: Mesh) -> dict[str, tuple]:
    """Split ``task``'s layers over ``mesh``'s ``model`` axis and wrap it
    in place with FSDP2 over its ``(data, fsdp)`` sub-mesh by
    :func:`infer_param_specs` (see the module docstring).
    Returns the specs. The task must be on the mesh's device."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    from mmlearn_tpu_torch.parallel.tensor_parallel import parallelize

    specs = infer_param_specs(task, mesh)
    parallelize(task, mesh, specs)
    by_param = {p: specs[n] for n, p in task.named_parameters()}
    dp_mesh = mesh.dp_mesh()

    def placement(param: nn.Parameter):
        return Shard(shard_dim(by_param[param]))

    scalars = {p for p in task.parameters() if p.ndim == 0}
    for unit in [*_units(task), task]:
        fully_shard(unit, mesh=dp_mesh, shard_placement_fn=placement, ignored_params=scalars)
    for method in TASK_METHODS:
        if hasattr(task, method):
            register_fsdp_forward_method(task, method)
    return specs


def sync_replicated_grads(task: nn.Module, mesh: Mesh) -> None:
    """Average the gradients of the parameters FSDP2 does not manage (plain
    tensors) over the ``data x fsdp`` ranks, in one all-reduce."""
    import torch
    import torch.distributed as dist

    grads = [p.grad for p in task.parameters()
             if p.grad is not None and not hasattr(p, "device_mesh")]
    if not grads or mesh.dp_size == 1:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=mesh.dp_group())
    flat /= mesh.dp_size
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
