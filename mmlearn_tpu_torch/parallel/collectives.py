"""Collectives over the mesh's process groups, counterpart of
:mod:`mmlearn_tpu.parallel.collectives`.

The JAX functions take a mesh axis name inside ``shard_map``; these take the
name of an axis of the global mesh (:func:`~mmlearn_tpu_torch.parallel.mesh.get_global_mesh`),
``"batch"`` for the ``data x fsdp`` group the batch is split over, or a
process group. In a process with no process group every collective is the
identity over one rank.

- :func:`all_gather` concatenates the ranks' tensors on dim 0. ``with_grad``
  gives the gradient of ``torch.distributed.nn``'s gather: the backward sums
  the gathered gradient over the ranks and returns this rank's rows (each
  rank's loss is then its share of a mean, as FSDP2 averages the ranks'
  gradients). ``with_grad=False`` is the reference's detached gather: the
  other ranks' rows carry no gradient, this rank's own rows do.
- :func:`psum`, :func:`pmean`, :func:`axis_index`, :func:`axis_size`,
  :func:`local_loss_label_offset` as the JAX ones.
- :func:`process_allgather` (tensors or numpy arrays, concatenated on dim 0
  in rank order; ragged leading dims allowed), :func:`process_allgather_object`,
  :func:`process_local_rows` and :func:`process_local_rows_device`: a
  process's arrays are its own rows already, so the last two return them.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

BATCH_AXES = "batch"


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _group(axis: Any):
    """The process group of ``axis`` (a name of the global mesh's axes,
    ``"batch"``, or a group as it is); ``None`` where there is no group.
    ``"batch"`` without a global mesh is every process."""
    if not _initialized():
        return None
    if not isinstance(axis, str):
        return axis
    import torch.distributed as dist

    from mmlearn_tpu_torch.parallel.mesh import get_global_mesh, peek_global_mesh

    if axis == BATCH_AXES:
        mesh = peek_global_mesh()
        return dist.group.WORLD if mesh is None or mesh.device_mesh is None else mesh.dp_group()
    return get_global_mesh().group(axis)


def axis_size(axis: Any = BATCH_AXES) -> int:
    import torch.distributed as dist

    group = _group(axis)
    return 1 if group is None else dist.get_world_size(group)


def axis_index(axis: Any = BATCH_AXES) -> int:
    import torch.distributed as dist

    group = _group(axis)
    return 0 if group is None else dist.get_rank(group)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    """All-gather on dim 0; the backward sums the gradient of the gathered
    tensor over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        group = ctx.group
        grad = grad.contiguous()
        dist.all_reduce(grad, group=group)
        rows = grad.shape[0] // dist.get_world_size(group)
        me = dist.get_rank(group)
        return grad[me * rows:(me + 1) * rows], None


def all_gather(x: torch.Tensor, axis: Any = BATCH_AXES, *, with_grad: bool = True,
               tiled: bool = True) -> torch.Tensor:
    """Gather ``x`` from every rank of ``axis``: concatenated on dim 0
    (``tiled``) or stacked on a new dim 0. ``with_grad=False``: detached,
    with this rank's own rows put back differentiable."""
    group = _group(axis)
    if group is None:
        return x if tiled else x[None]
    if with_grad:
        gathered = _AllGather.apply(x, group)
    else:
        import torch.distributed as dist

        me, rows = dist.get_rank(group), x.shape[0]
        detached = _gather_rows(x.detach(), group)
        gathered = torch.cat([detached[:me * rows], x, detached[(me + 1) * rows:]])
    return gathered if tiled else gathered.view(-1, *x.shape)


def psum(x: torch.Tensor, axis: Any = BATCH_AXES) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    import torch.distributed as dist

    group = _group(axis)
    out = x.clone()
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def pmean(x: torch.Tensor, axis: Any = BATCH_AXES) -> torch.Tensor:
    return psum(x, axis) / axis_size(axis)


def local_loss_label_offset(axis: Any, local_batch: int) -> int:
    """The global column of local row 0's positive when only one side's
    rows are gathered: ``rank * local_batch``."""
    return axis_index(axis) * local_batch


def process_allgather(x: Union[torch.Tensor, np.ndarray, Any]) -> Any:
    """Every process's ``x`` concatenated on dim 0 in rank order over the
    batch's shards (``data x fsdp``; leading dims may differ); a tensor stays
    on its device, a numpy array comes back as numpy. One process returns
    ``x`` as it is."""
    if not _initialized():
        return x
    import torch.distributed as dist

    group = _group(BATCH_AXES)
    if isinstance(x, torch.Tensor):
        sizes = process_allgather_object(int(x.shape[0]))
        if len(set(sizes)) == 1:
            return _gather_rows(x, group)
        width = max(sizes)
        padded = x.new_zeros((width, *x.shape[1:]))
        padded[:x.shape[0]] = x
        parts = [torch.empty_like(padded) for _ in sizes]
        dist.all_gather(parts, padded, group=group)
        return torch.cat([p[:n] for p, n in zip(parts, sizes)])
    return np.concatenate(process_allgather_object(np.asarray(x)))


def process_allgather_object(obj: Any) -> list:
    """``[obj of process 0, obj of process 1, ...]`` over the batch's
    shards (pickled; one process returns ``[obj]``)."""
    group = _group(BATCH_AXES)
    if group is None:
        return [obj]
    import torch.distributed as dist

    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def process_local_rows(arr: Any) -> np.ndarray:
    """This process's rows of ``arr`` on the host: a process holds its own
    rows, so this is ``arr`` as numpy."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def process_local_rows_device(arr: Any) -> Any:
    """This process's rows of ``arr``, where they are."""
    return arr


__all__ = ["all_gather", "axis_index", "axis_size", "local_loss_label_offset", "pmean",
           "process_allgather", "process_allgather_object", "process_local_rows",
           "process_local_rows_device", "psum"]
