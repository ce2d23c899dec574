"""Multi-process start-up.

Counterpart of ``vaura_tpu/parallel/multihost.py``. The JAX package calls
``jax.distributed.initialize()``; here one process runs per card (started by
``torchrun``, or by SLURM with one task per card) and joins a
``torch.distributed`` process group: NCCL for ``cuda``, gloo for ``cpu``.
The rank, world size and rendezvous come from the arguments or from the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK`` as torchrun sets them; ``SLURM_PROCID``, ``SLURM_NTASKS``,
``SLURM_LOCALID`` under SLURM). A process whose world is one does nothing.
A world that is larger and cannot form raises: there is no quiet fallback
to one process.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# how long a collective may wait before the process group gives up
TIMEOUT_S = 600
# the control channel (``ControlChannel``): how long a follower waits for
# rank 0's next header, and how often an idle rank 0 sends a no-op one
CONTROL_TIMEOUT_S = 1800
HEARTBEAT_S = 60


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name) not in (None, ""):
            return int(os.environ[name])
    return None


def launched() -> bool:
    """Whether a launcher (torchrun, SLURM) started this process as one
    rank of a run, of any size; the actions place a run so started on a
    mesh (a mesh of one card for ``--nproc_per_node=1``), a plain ``python``
    run on one device."""
    return any(os.environ.get(k) not in (None, "")
               for k in ("WORLD_SIZE", "SLURM_NTASKS"))


def world_from_env() -> int:
    """The world size the environment announces (torchrun's or SLURM's),
    1 when neither does."""
    return _env_int("WORLD_SIZE", "SLURM_NTASKS") or 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> bool:
    """Join the process group of a multi-process run; returns whether one
    is (now) initialised. ``coordinator_address`` is ``host:port`` of rank
    0 (default ``MASTER_ADDR``/``MASTER_PORT``), ``num_processes`` the world
    size, ``process_id`` this rank. ``device_type`` picks the backend
    (``cuda`` -> NCCL, ``cpu`` -> gloo); on ``cuda`` the process takes card
    ``LOCAL_RANK`` (``SLURM_LOCALID``; else the rank modulo the card count)
    as its current device. Must run before anything touches a card."""
    if dist.is_initialized():
        return True
    world = num_processes if num_processes is not None else world_from_env()
    if coordinator_address is None and world <= 1:
        logger.info("single-process run; no process group")
        return False
    rank = process_id if process_id is not None else _env_int(
        "RANK", "SLURM_PROCID")
    if rank is None:
        raise RuntimeError(f"a world of {world} processes needs this "
                           "process's rank (RANK or SLURM_PROCID)")
    if coordinator_address is None:
        host = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise RuntimeError("a multi-process run needs MASTER_PORT (or a "
                               "coordinator_address host:port)")
        coordinator_address = f"{host}:{port}"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: a multi-process run on "
                               "cards needs one card per process")
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID")
        local = rank % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type {device_type!r}: cuda or cpu")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    logger.info("initialized distributed: process %d/%d (%s)", rank, world,
                backend)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gating of side effects (checkpoints, TensorBoard, output
    files), as the JAX package gates them on process 0."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (nothing in a single process)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself in a single
    process)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class ControlChannel:
    """Rank 0's jobs to every other rank of a run (the server's leader and
    followers, ``scripts/serve.py``): a job is a header (a small picklable
    dict) and tensors. The headers go over a CPU ``gloo`` group of their
    own, the tensors over the default (device) group.

    A follower waits for the next header between jobs, as long as the
    server is idle. The headers' group is gloo, so no NCCL collective waits
    meanwhile and NCCL's watchdog, which ends a process whose collective
    outlives the group's timeout, has nothing to end. Rank 0 sends a no-op
    header whenever ``HEARTBEAT_S`` passed since its last header (the
    server's worker does, between jobs and while idle), so a follower's wait
    stays below ``CONTROL_TIMEOUT_S`` however long the server idles or
    serves without it, and a follower still learns within that timeout that
    rank 0 hangs or has gone: it costs one small broadcast a minute at
    most, and the timeout needs no guess of the longest idle spell."""

    def __init__(self, device, timeout_s: Optional[float] = None):
        self.device = torch.device(device)
        self.leader = process_index() == 0
        self.group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=timeout_s or CONTROL_TIMEOUT_S))

    def broadcast(self, header: Optional[dict] = None, tensors=()):
        """Rank 0's ``(header, tensors)`` on every rank: rank 0 passes
        them (tensors of any device; they travel on ``device``), the others
        pass nothing and get them. Every rank calls it for each job, in
        the same order."""
        box = [None]
        if self.leader:
            box = [dict(header, tensors=[
                (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
                for t in tensors])]
        dist.broadcast_object_list(box, src=0, group=self.group)
        header = box[0]
        specs = header.pop("tensors")
        if self.leader:
            out = [t.to(self.device).contiguous() for t in tensors]
        else:
            out = [torch.empty(shape, dtype=getattr(torch, dtype),
                               device=self.device) for shape, dtype in specs]
        for t in out:
            dist.broadcast(t, src=0)
        return header, out

    def all_ok(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (a collective over the
        headers' group)."""
        flag = torch.tensor([int(bool(ok))], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())
