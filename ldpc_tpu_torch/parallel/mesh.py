"""Process groups and the ("data", "model") device mesh (counterpart of
``ldpc_tpu.parallel.mesh``).

The JAX package runs one controller over every device; torch runs one
process per rank (``torchrun``, or ``RANK``/``WORLD_SIZE`` set by hand), and
:func:`make_mesh` lays the process group's ranks out as a
``torch.distributed.device_mesh.DeviceMesh``.  Only the data axis is taken:
a ``model`` axis over 1 (tensor parallelism) waits for ROADMAP §A6b.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

MESH_DIMS = ("data", "model")
TENSOR_PARALLEL_ITEM = "ROADMAP §A6b (tensor parallelism)"


def distributed_init(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     timeout: float = 600.0) -> None:
    """Join the process group.

    Idempotent: a second call on a live group is a no-op.  Loud otherwise:
    a bad ``init_method`` or a world that never forms raises within
    ``timeout`` seconds and never degrades to one process.  With no
    arguments it reads the launcher's environment (``torchrun``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  ``backend`` defaults
    to ``nccl`` where torch sees a card and ``gloo`` otherwise; with
    ``nccl`` each process takes the card ``LOCAL_RANK`` (default its rank).
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size or -1,
                            rank=-1 if rank is None else rank,
                            timeout=datetime.timedelta(seconds=timeout))


def make_mesh(data: int | None = None, model: int = 1):
    """A ("data", "model") ``DeviceMesh`` over the ranks of the process group.

    ``data`` defaults to every rank (pure data parallelism, the scaling axis
    of Monte-Carlo sweeps and training).  Raises where ``data * model`` is
    not the world size, and for ``model > 1``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call distributed_init() first")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if model > 1:
        raise NotImplementedError(f"a model axis of {model} (tensor parallelism) is not ported: "
                                  f"it waits for {TENSOR_PARALLEL_ITEM}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=MESH_DIMS)


def batch_sharding(mesh) -> tuple:
    """Placements of a (B, ...) tensor: batch split over the data axis."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())
