"""The ``(data, fsdp, model)`` device mesh.

Counterpart of ``vaura_tpu/parallel/mesh.py``: up to three axes,

  * ``data``  -- batch (pure data parallelism),
  * ``fsdp``  -- parameter and optimizer-state sharding (ZeRO style) that
    also carries batch shards,
  * ``model`` -- tensor parallelism over attention heads and the
    feed-forward hidden width.

One process runs per card; the mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the process group (``multihost.initialize_distributed``),
rank ``(d * fsdp + f) * model + m`` at coordinate ``(d, f, m)``. Where JAX
places a batch with ``device_put(batch, batch_sharding(mesh))``, every rank
here builds the same global batch (from the same seed or loader) and keeps
its own rows (``batch_rows``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("data", "fsdp", "model")


def mesh_shape(n: int, data: int = -1, fsdp: int = 1, model: int = 1
               ) -> Tuple[int, int, int]:
    """``(data, fsdp, model)`` of a mesh over ``n`` ranks, with the JAX
    package's rules: ``data=-1`` absorbs the ranks ``fsdp * model`` leave,
    and the product must be ``n``."""
    if data == -1:
        assert n % (fsdp * model) == 0, f"{n} devices not divisible by {fsdp * model}"
        data = n // (fsdp * model)
    assert data * fsdp * model == n, f"mesh {data}x{fsdp}x{model} != {n} devices"
    return data, fsdp, model


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, fsdp, model)`` ``DeviceMesh`` over every rank of the
    process group (``multihost.initialize_distributed`` first; a run of
    one process forms a group of one for a mesh of 1 x 1 x 1)."""
    if not dist.is_initialized():
        # one process (initialize_distributed forms no group for a world of
        # one): a group of one, for a mesh of 1 x 1 x 1
        if mesh_shape(1, data, fsdp, model) != (1, 1, 1):
            raise RuntimeError("a mesh of several ranks needs a process "
                               "group (multihost.initialize_distributed)")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(
        device_type, mesh_shape(dist.get_world_size(), data, fsdp, model),
        mesh_dim_names=MESH_AXES)


def batch_index(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(i, n)``: this rank's shard of the batch and the number of shards,
    over the flattened ``(data, fsdp)`` axes (JAX's
    ``P(("data", "fsdp"))``)."""
    d, f, _ = mesh.get_coordinate()
    return d * mesh.size(1) + f, mesh.size(0) * mesh.size(1)


def batch_rows(mesh: DeviceMesh, global_batch: int) -> slice:
    """The rows of a global batch of ``global_batch`` that this rank holds
    (the counterpart of ``batch_sharding``): contiguous blocks over
    ``(data, fsdp)``; ranks that differ only in ``model`` hold the same
    rows."""
    i, n = batch_index(mesh)
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by "
                         f"data*fsdp={n}")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: DeviceMesh, batch):
    """``batch_rows`` of every array leaf of a (nested) batch dict: numpy
    arrays and tensors with a leading batch axis; meta leaves that are lists
    of one entry a row are cut too, other leaves kept."""
    import numpy as np

    n_rows = None

    def rows_of(x):
        nonlocal n_rows
        if isinstance(x, dict):
            return {k: rows_of(v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
            n_rows = x.shape[0] if n_rows is None else n_rows
            return x[batch_rows(mesh, x.shape[0])]
        return x

    out = rows_of(batch)

    def lists(x):
        if isinstance(x, dict):
            return {k: lists(v) for k, v in x.items()}
        if isinstance(x, list) and n_rows is not None and len(x) == n_rows:
            return x[batch_rows(mesh, n_rows)]
        return x

    return lists(out)


def replicated(mesh: DeviceMesh):
    """The placements of a tensor held whole by every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))
