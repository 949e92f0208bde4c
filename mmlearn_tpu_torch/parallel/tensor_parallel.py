"""Tensor parallelism over the mesh's ``model`` axis: the ``model`` entries
of the JAX package's partitioning rules applied.

A rule that puts ``model`` on a Dense kernel's output dim (``attn/qkv``,
``mlp/fc1|up|gate|linear_0``) splits the layer column-wise: each rank of the
``model`` group holds rows ``r * out / P ... (r + 1) * out / P - 1`` of the
port's ``(out, in)`` weight and computes that share of the output. One that
puts it on the input dim (``attn/proj|out|out_proj``, ``mlp/fc2|down|
linear_1``) splits it row-wise: each rank holds a share of the input columns,
computes a partial product without its bias, and the partial products are
all-reduced over the group before the bias is added, once (the style's
hooks: the layer itself stays a plain ``F.linear``).
Biases, norms, embeddings, heads and the logit scale stay replicated over
``model``, as the JAX rules leave them.

The splits are PyTorch's ``ColwiseParallel`` / ``RowwiseParallel`` styles
(local outputs) applied by ``parallelize_module`` over the ``model``
sub-mesh (:func:`parallelize`), before FSDP2 shards every parameter over
``(data, fsdp)``: the recipe of 2-D parallelism. A split weight is then a
``DTensor`` over ``(data, fsdp, model)``; what the layers compute with is
plain local tensors, so the kernels' autograd Functions see plain tensors.

Because ``qkv`` is packed head-major (``[h0_q | h0_k | h0_v | h1_q | ...]``),
an equal split of its output rows lands on whole heads: rank ``r`` computes
heads ``r * H / P ... (r + 1) * H / P - 1``, the JAX ``P(batch, None,
model)`` layout of ``fused_mha``'s sharded plan. Where it does not (``H``
not a multiple of ``P``), ``qkv``'s output is gathered over the group and
every rank runs every head, as XLA computes that layout in the JAX package.
An MLP with a norm between its layers gathers the same way.

The pairing of the styles inside a layer: a column split whose next layer
is split row-wise hands it its local share (``Shard(-1)``); otherwise its
output is gathered (``Replicate``), and a row split after a layer that was
not split takes its share of the whole input locally.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

COLUMN = "column"
ROW = "row"


def _distribute(module: nn.Module, device_mesh, weight_dim: int) -> None:
    """``module``'s weight split on ``weight_dim`` over ``device_mesh``, its
    bias replicated; each rank cuts its share locally (every rank built the
    same weights from the same seed)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    for name, p in list(module.named_parameters(recurse=False)):
        placement = Shard(weight_dim) if name == "weight" else Replicate()
        module.register_parameter(name, nn.Parameter(
            distribute_tensor(p.data, device_mesh, [placement], src_data_rank=None),
            requires_grad=p.requires_grad))


def _styles():
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    class ColumnParallel(ColwiseParallel):
        """Output rows of the weight split; the bias replicated."""

        def _partition_linear_fn(self, name, module, device_mesh):
            _distribute(module, device_mesh, 0)

    class RowParallel(RowwiseParallel):
        """Input columns of the weight split; the bias replicated and added
        once, to the all-reduced sum: the input hook takes it out of the
        layer for the layer's own product, the output hook adds it after the
        reduction and puts it back."""

        def _partition_linear_fn(self, name, module, device_mesh):
            _distribute(module, device_mesh, 1)

        @staticmethod
        def _prepare_input_fn(input_layouts, desired_input_layouts, mod, inputs, device_mesh):
            if "held_bias" not in mod.__dict__:  # else a forward that raised left it held
                mod.__dict__["held_bias"] = mod._parameters["bias"]
                mod._parameters["bias"] = None
            return RowwiseParallel._prepare_input_fn(input_layouts, desired_input_layouts, mod,
                                                     inputs, device_mesh)

        @staticmethod
        def _prepare_output_fn(output_layouts, use_local_output, mod, outputs, device_mesh):
            bias = mod.__dict__.pop("held_bias")
            mod._parameters["bias"] = bias
            outputs = outputs.redistribute(placements=output_layouts)
            if bias is not None:
                outputs = outputs + bias.to(outputs.dtype)
            return outputs.to_local() if use_local_output else outputs

    return ColumnParallel, RowParallel


def tp_plan(module: nn.Module, specs: dict[str, tuple], model: int) -> dict[str, tuple]:
    """``{Dense name: (COLUMN or ROW, gathered)}`` for every Dense whose
    spec puts ``model`` on a dim: ``gathered`` is, for a column split, that
    its output is gathered over the group (``Shard(-1)`` otherwise) and, for
    a row split, that its input is whole. Raises for a split layer outside
    an attention layer or an MLP, whose pairing the port does not know."""
    from mmlearn_tpu_torch.modules.layers.attention import Attention
    from mmlearn_tpu_torch.modules.layers.mlp import MLP

    def kind(name: str) -> Optional[str]:
        spec = specs.get(f"{name}.weight", ())
        if MODEL_AXIS not in spec:
            return None
        return COLUMN if spec.index(MODEL_AXIS) == 0 else ROW

    plan: dict[str, tuple] = {}
    for name, mod in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, Attention):
            chain = [("qkv", mod.num_heads % model == 0), ("proj", True)]
        elif isinstance(mod, MLP):
            chain = [(f"fc{i}", not hasattr(mod, f"norm{i}"))
                     for i in range(1, mod.num_layers + 1)]
        else:
            continue
        kinds = [kind(prefix + layer) for layer, _ in chain]
        for i, ((layer, aligned), k) in enumerate(zip(chain, kinds)):
            if k == COLUMN:
                hands_on = i + 1 < len(chain) and kinds[i + 1] == ROW and aligned
                plan[prefix + layer] = (COLUMN, not hands_on)
            elif k == ROW:
                takes = i > 0 and kinds[i - 1] == COLUMN and not plan[
                    prefix + chain[i - 1][0]][1]
                plan[prefix + layer] = (ROW, not takes)
    for name, spec in specs.items():
        layer = name.rsplit(".", 1)[0]
        if MODEL_AXIS in spec and layer not in plan:
            raise NotImplementedError(
                f"{name}: a model split outside an attention layer or an MLP")
    return plan


def parallelize(module: nn.Module, mesh: Mesh, specs: dict[str, tuple]) -> dict[str, tuple]:
    """Split ``module``'s layers in place over ``mesh``'s ``model`` axis by
    :func:`tp_plan`, and record on each attention layer and MLP whose
    hidden width is split this rank's place in the group
    (``model_shard = (rank, size)``), by which they slice their dropout
    masks. Returns the plan; a mesh whose ``model`` is 1 changes nothing."""
    if mesh.model_size == 1:
        return {}
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import parallelize_module

    from mmlearn_tpu_torch.modules.layers.attention import Attention
    from mmlearn_tpu_torch.modules.layers.mlp import MLP

    plan = tp_plan(module, specs, mesh.model_size)
    column, row = _styles()
    styles = {}
    for name, (k, gathered) in plan.items():
        if k == COLUMN:
            styles[name] = column(output_layouts=Replicate() if gathered else Shard(-1),
                                  use_local_output=True)
        else:
            styles[name] = row(input_layouts=Replicate() if gathered else Shard(-1),
                               output_layouts=Replicate(), use_local_output=True)
    parallelize_module(module, mesh.model_mesh(), styles)
    shard = (mesh.model_rank, mesh.model_size)
    for name, mod in module.named_modules():
        prefix = f"{name}." if name else ""
        first = prefix + ("qkv" if isinstance(mod, Attention) else "fc1")
        if isinstance(mod, (Attention, MLP)) and plan.get(first, (None, True)) == (COLUMN,
                                                                                    False):
            mod.model_shard = shard
    return plan


def local_slice(t: Optional[torch.Tensor], dim: int,
                shard: Optional[tuple[int, int]]) -> Optional[torch.Tensor]:
    """This rank's ``1 / size`` of ``t`` along ``dim`` (``t`` itself where
    ``shard`` or ``t`` is ``None``): a mask drawn for the whole layer, cut to
    the heads or hidden columns the rank computes."""
    if t is None or shard is None:
        return t
    rank, size = shard
    width = t.shape[dim] // size
    return t.narrow(dim, rank * width, width)


def gather_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's shares of ``x`` concatenated on ``dim`` in rank
    order; the gradient flows to this rank's own share only (every rank uses
    the whole alike, so its own share's gradient is already whole)."""
    import torch.distributed as dist

    from mmlearn_tpu_torch.parallel.mesh import get_global_mesh

    mesh = get_global_mesh()
    group = mesh.group(MODEL_AXIS)
    parts = [torch.empty_like(x) for _ in range(mesh.model_size)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    parts[mesh.model_rank] = x
    return torch.cat(parts, dim=dim)
