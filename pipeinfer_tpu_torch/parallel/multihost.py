"""Multi-process initialization and global meshes.

Torch counterpart of pipeinfer_tpu.parallel.multihost. The reference
scales across hosts with an MPI world (mpirun + the ggml-mpi ring, ref:
ggml-mpi.c:38-75 init, README.md:144-160 hostfile UX); the JAX package
joins a jax.distributed coordinator and sees one global device list. The
port joins a torch.distributed process group over ``tcp://``, and a
global mesh tags each coordinate with the rank that owns it, so every
process runs the same program on its own coordinates (multi-controller
SPMD) and the collectives of parallel.mesh cross the process boundary
through torch.distributed.

``global_mesh`` lays the (data, stage, model) mesh out so that the STAGE
axis crosses processes (a pipeline hop moves one activation per
microbatch) while tensor parallelism stays within one process, the same
placement as the reference's one-pipeline-stage-per-node split.
"""

from __future__ import annotations

import datetime
from typing import Sequence

import numpy as np
import torch

from ..runtime.context import _params_to
from .mesh import Mesh, default_devices


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "gloo",
    timeout_s: float = 600.0,
):
    """Join this process to the process group (the mpirun counterpart):
    ``host:port`` of the coordinator (rank 0 listens there), the number of
    processes and this one's rank. No-op for a single-process run
    (coordinator_address None) or when the group is already set up.

    backend: gloo on the CPU and for processes that share a card (NCCL
    refuses two ranks on one GPU); nccl only where each rank owns its own
    card. A collective that waits longer than timeout_s raises. Every
    process calls shutdown() when it is done."""
    import torch.distributed as dist

    if coordinator_address is None or dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group (the counterpart of jax.distributed's
    shutdown, which jax runs at exit): wait at a barrier until every
    process is done, then destroy the group. Without it a process that
    finishes first exits while its peers still hold gloo pairs to it, and
    the group's threads are torn down by the interpreter's exit, which
    can abort a process ("terminate called without an active exception").
    No-op without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    dist.barrier()
    dist.destroy_process_group()


def global_devices(local_devices: Sequence | None = None) -> tuple[list[str], list[int]]:
    """The global device list and each entry's owning rank: every
    process's `local_devices` (default all of its CUDA cards) in rank
    order. Every process must pass lists of one length."""
    import torch.distributed as dist

    local = [str(d) for d in (local_devices if local_devices is not None
                              else default_devices(torch.cuda.device_count()))]
    if not (dist.is_available() and dist.is_initialized()):
        return local, [0] * len(local)
    lists: list = [None] * dist.get_world_size()
    dist.all_gather_object(lists, local)
    if len({len(x) for x in lists}) != 1:
        raise ValueError(f"processes hold {[len(x) for x in lists]} devices: need one count")
    return ([d for x in lists for d in x],
            [r for r, x in enumerate(lists) for _ in x])


def global_mesh(pp: int = 1, tp: int = 1, dp: int = 1,
                local_devices: Sequence | None = None) -> Mesh:
    """A (data, stage, model) mesh over ALL processes' devices, stage axis
    outermost in device order so each pipeline stage lands in one process
    where possible."""
    devs, ranks = global_devices(local_devices)
    need = pp * tp * dp
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)} global")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    grid = grid.reshape(pp, dp, tp).transpose(1, 0, 2)
    rgrid = np.asarray(ranks[:need]).reshape(pp, dp, tp).transpose(1, 0, 2)
    return Mesh(grid, ("data", "stage", "model"), rgrid)


def replicate_to_mesh(tree, mesh: Mesh) -> list:
    """A host-local tree (dicts, lists, tensors, arrays) replicated over
    the mesh: one copy per local coordinate, on its device. Every process
    calls it with the same values (the model-load pattern: each process
    reads the same GGUF, the counterpart of the reference's shared model
    files and per-rank mmap)."""
    return [_params_to(tree, dev) for dev in mesh.local_devices]
