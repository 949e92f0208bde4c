"""The device mesh and the batch placement, counterpart of
:mod:`mmlearn_tpu.parallel.mesh`.

The JAX mesh's named axes over the processes of ``torch.distributed``, one
device a process:

- ``data``: data parallelism; the batch is split over ``data x fsdp``;
- ``fsdp``: weight sharding (FSDP2 ``fully_shard`` over the ``(data, fsdp)``
  sub-mesh: replicated over ``data``, sharded over ``fsdp``);
- ``seq`` (present only when > 1, between ``fsdp`` and ``model``): the
  sequence of a ring-attention layer is split over it
  (:mod:`~mmlearn_tpu_torch.ops.ring_attention`); its ranks hold the same
  rows of the batch;
- ``model``: tensor parallelism (innermost): the attention and MLP
  projections are split column- and row-wise over it
  (:mod:`~mmlearn_tpu_torch.parallel.tensor_parallel`), each rank running
  its share of the heads and of the MLP's hidden width; its ranks hold the
  same rows of the batch.

:class:`Mesh` holds a ``torch.distributed.device_mesh.DeviceMesh`` with
those names where ``torch.distributed`` is initialized; a process that never
initialized it is a mesh of one device with no groups. The rank order is the
JAX mesh's device order: row-major over ``(data, fsdp[, seq], model)``.

The JAX package's ``slices`` (a hybrid ICI/DCN mesh) has no counterpart in
the layout: a multi-node job is plain process groups over the same axes;
``slices`` is still checked to divide ``data``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)
MESH_AXES_SEQ = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, MODEL_AXIS)

_GLOBAL_MESH: Optional["Mesh"] = None


def mesh_shape(n: int, data: int = -1, fsdp: int = 1, model: int = 1, seq: int = 1,
               slices: int = 1) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """The axis names and sizes of ``create_mesh`` over ``n`` devices, with
    the JAX function's rules and errors (``data=-1`` fills what the other
    axes leave)."""
    other = fsdp * model * seq
    if data == -1:
        if n % other != 0:
            raise ValueError(f"{n} devices not divisible by fsdp*seq*model={other}")
        data = n // other
    if data * other > n:
        raise ValueError(f"Mesh {data}x{fsdp}x{seq}x{model} needs more than the {n} available "
                         "devices")
    if slices > 1 and data % slices != 0:
        raise ValueError(f"data={data} must be divisible by slices={slices}")
    if seq > 1:
        return MESH_AXES_SEQ, (data, fsdp, seq, model)
    return MESH_AXES, (data, fsdp, model)


class Mesh:
    """Named mesh axes over the processes (see the module docstring).

    ``shape`` maps each axis name to its size, ``axis_names`` keeps their
    order, ``device`` is this process's device, ``device_mesh`` the
    ``DeviceMesh`` (``None`` in an uninitialized process)."""

    def __init__(self, axis_names, sizes, device: torch.device, device_mesh=None,
                 seq_exchange=None, rank: int = 0, dp_group=None) -> None:
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.rank = int(rank)
        self._seq_exchange = seq_exchange
        self._dp_group = dp_group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp_size(self) -> int:
        """Ranks that hold different rows of the batch: ``data x fsdp``."""
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def model_rank(self) -> int:
        """This process's place in its ``model`` group (the innermost axis)."""
        return self.rank % self.model_size

    @property
    def dp_rank(self) -> int:
        """This process's place among the :attr:`dp_size` row shards (the
        axes after ``fsdp`` vary fastest in the rank order)."""
        return self.rank // (self.size // self.dp_size)

    def group(self, axis: str):
        """The process group of this rank along ``axis``."""
        return self.device_mesh.get_group(axis)

    def dp_mesh(self):
        """The 2-D ``(data, fsdp)`` sub-mesh FSDP2 shards over."""
        return self.device_mesh[DATA_AXIS, FSDP_AXIS]

    def model_mesh(self):
        """The 1-D ``model`` sub-mesh the projections are split over."""
        return self.device_mesh[MODEL_AXIS]

    def dp_group(self):
        """One process group over ``data x fsdp`` (the batch's shards): the
        ranks that share this rank's ``seq`` coordinate."""
        return self._dp_group

    def seq_exchange(self):
        """The ring's exchange over this rank's ``seq`` group (one for the
        mesh's life: its ``hops`` count every ring layer's hops)."""
        if self._seq_exchange is None:
            from mmlearn_tpu_torch.ops.ring_attention import GroupExchange

            self._seq_exchange = GroupExchange(self.group(SEQ_AXIS))
        return self._seq_exchange

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def default_device(device: Optional[torch.device | str] = None) -> torch.device:
    """``cuda:LOCAL_RANK`` unless ``device`` says otherwise (``"cpu"``, or a
    device of its own)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_from_env(device: Optional[torch.device | str] = None,
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group that the environment describes (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``): NCCL for a
    CUDA device (bound to ``LOCAL_RANK``, one process a card), gloo for the
    CPU, or the ``backend`` given (gloo for several processes sharing one
    card, which NCCL refuses). Returns this process's device; a group
    already joined is kept."""
    import torch.distributed as dist

    device = default_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                device_id=device if backend == "nccl" else None)
    return device


def create_mesh(
    data: int = -1,
    fsdp: int = 1,
    model: int = 1,
    seq: int = 1,
    slices: int = 1,
    device: Optional[torch.device | str] = None,
) -> Mesh:
    """The mesh over every process of ``torch.distributed`` (one device, no
    groups, where it is not initialized). Sizes and errors are the JAX
    function's; the mesh covers every process."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    names, sizes = mesh_shape(n, data, fsdp, model, seq, slices)
    if math.prod(sizes) != n:
        raise ValueError(f"Mesh {'x'.join(map(str, sizes))} must cover all {n} processes")
    if device is None and initialized and dist.get_backend() == "gloo":
        device = "cpu"
    device = default_device(device)
    if not initialized:
        return Mesh(names, sizes, device)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device.type, sizes, mesh_dim_names=names)
    rank = dist.get_rank()
    # one group over data x fsdp a (seq, model) coordinate; every rank makes every one
    inner = n // (sizes[0] * sizes[1])
    dp_group = dist.group.WORLD
    if inner > 1:
        for s in range(inner):
            group = dist.new_group([r for r in range(n) if r % inner == s])
            if rank % inner == s:
                dp_group = group
    return Mesh(names, sizes, device, device_mesh, rank=rank, dp_group=dp_group)


def emulated_seq_mesh(seq: int, device: torch.device | str = "cpu") -> Mesh:
    """A one-process mesh whose ``seq`` ring runs every rank's hops here
    (:class:`~mmlearn_tpu_torch.ops.ring_attention.ListExchange`): the test
    driver of the ring branch, on the CPU and on one card."""
    from mmlearn_tpu_torch.ops.ring_attention import ListExchange

    return Mesh(MESH_AXES_SEQ, (1, 1, seq, 1), torch.device(device),
                seq_exchange=ListExchange(seq))


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Mesh:
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = create_mesh()
    return _GLOBAL_MESH


def peek_global_mesh() -> Optional[Mesh]:
    """The active mesh if one was set, without creating a default one."""
    return _GLOBAL_MESH


def batch_spec() -> tuple:
    """The batch dimension's axes: ``data`` and ``fsdp`` jointly."""
    return ((DATA_AXIS, FSDP_AXIS),)


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    """Rows a rank holds of a global batch."""
    if global_batch_size % mesh.dp_size != 0:
        raise ValueError(f"Global batch {global_batch_size} not divisible by the "
                         f"{mesh.dp_size} batch shards (data x fsdp)")
    return global_batch_size // mesh.dp_size


def _batch_dim(batch: Mapping[str, Any]) -> Optional[int]:
    """The global batch size: the leading dim of any modality array."""
    from mmlearn_tpu_torch.datasets.core.modalities import Modalities

    for key, value in batch.items():
        if Modalities.has_modality(str(key)) and hasattr(value, "shape") and len(value.shape):
            return int(value.shape[0])
    return None


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global host batch: the ``dp_rank``-th of
    ``dp_size`` equal slices, in rank order over ``data x fsdp`` (the ranks
    of a ``seq`` group keep the same rows).

    Masks (a key ending in ``_masks``: I-JEPA's, ``(n_masks, B, K)``) are
    sliced on their second dimension, whatever the mask count; other arrays
    that lead with the batch dimension are sliced on it, and arrays that
    lead with another and carry the batch second on the second; scalars,
    strings, lists and arrays of other shapes are kept whole. A batch that
    does not divide raises."""
    if mesh.dp_size == 1 or not isinstance(batch, Mapping):
        return batch
    b = _batch_dim(batch)
    if b is None:
        return batch
    rows = local_batch_size(b, mesh)
    lo = mesh.dp_rank * rows

    def cut(value: Any, key: str) -> Any:
        if isinstance(value, Mapping):
            return {k: cut(v, str(k)) for k, v in value.items()}
        if not isinstance(value, (np.ndarray, torch.Tensor)) or value.ndim == 0:
            return value
        second = value.ndim >= 2 and value.shape[1] == b
        if second and key.endswith("_masks"):
            return value[:, lo:lo + rows]
        if value.shape[0] == b:
            return value[lo:lo + rows]
        if second:
            return value[:, lo:lo + rows]
        return value

    return {k: cut(v, str(k)) for k, v in batch.items()}
