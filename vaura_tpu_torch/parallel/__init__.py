"""Multi-device training and generation over a ``(data, fsdp, model)``
mesh: one process per card (``torchrun``), ``torch.distributed``,
``DeviceMesh``, FSDP2 over ``(data, fsdp)`` and explicit tensor-parallel
collectives over ``model``. Counterpart of ``vaura_tpu/parallel``."""

from vaura_tpu_torch.parallel.mesh import (
    MESH_AXES,
    batch_rows,
    make_mesh,
    mesh_shape,
    replicated,
)
from vaura_tpu_torch.parallel.multihost import (
    initialize_distributed,
    is_main_process,
)
from vaura_tpu_torch.parallel.partitioning import (
    MeshPlacement,
    param_specs,
    port_spec,
    shard_module,
    spec_for,
)

__all__ = [
    "MESH_AXES",
    "batch_rows",
    "make_mesh",
    "mesh_shape",
    "replicated",
    "initialize_distributed",
    "is_main_process",
    "MeshPlacement",
    "param_specs",
    "port_spec",
    "shard_module",
    "spec_for",
]
