"""Parallelism over ``torch.distributed``: the mesh, the partitioning rules
with FSDP2 and the ``model`` axis' column and row splits
(:mod:`~mmlearn_tpu_torch.parallel.tensor_parallel`), the collectives.
Counterpart of :mod:`mmlearn_tpu.parallel`."""

from mmlearn_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    axis_size,
    local_loss_label_offset,
    pmean,
    process_allgather,
    psum,
)
from mmlearn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    MESH_AXES,
    MESH_AXES_SEQ,
    MODEL_AXIS,
    SEQ_AXIS,
    batch_spec,
    create_mesh,
    get_global_mesh,
    local_batch_size,
    set_global_mesh,
    shard_batch,
)
from mmlearn_tpu_torch.parallel.partitioning import (
    DEFAULT_RULES,
    infer_param_specs,
    shard_task,
)

__all__ = [
    "DATA_AXIS",
    "DEFAULT_RULES",
    "FSDP_AXIS",
    "MESH_AXES",
    "MESH_AXES_SEQ",
    "SEQ_AXIS",
    "MODEL_AXIS",
    "all_gather",
    "axis_index",
    "axis_size",
    "batch_spec",
    "create_mesh",
    "get_global_mesh",
    "infer_param_specs",
    "local_batch_size",
    "local_loss_label_offset",
    "pmean",
    "process_allgather",
    "psum",
    "set_global_mesh",
    "shard_batch",
    "shard_task",
]
