"""Multi-process bootstrap (counterpart of
phase_vocoder_tpu/parallel/distributed.py).

One process per device, on one host or many: initialize() joins the
process group (NCCL between cards, gloo on the CPU or for several
processes sharing one card), and global_mesh / global_mesh_2d lay every
rank out as a mesh. The chunked and batched bodies then run the same code
on every rank, whatever the number of hosts.
"""

from __future__ import annotations

import datetime
import logging
import socket

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, make_mesh_2d

logger = logging.getLogger(__name__)

__all__ = ["initialize", "global_mesh", "global_mesh_2d", "free_port"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no process listens on now: the
    coordinator address of processes started on one host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> None:
    """Join the default process group (once per process, before building
    a mesh).

    coordinator_address "host:port" (rank 0 listens there) with
    num_processes and process_id; with no address, the torchrun variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). backend: "nccl" or
    "gloo"; default NCCL when a card is visible, else gloo. With a card,
    the process's current device becomes cuda:(rank mod the card count).
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs,
        )
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    logger.info(
        "torch.distributed initialized: rank %d/%d, backend %s",
        dist.get_rank(), dist.get_world_size(), backend,
    )


def global_mesh(axis: str = "seq") -> Mesh:
    """1-D mesh over every rank of every host."""
    return make_mesh(None, axis)


def global_mesh_2d(data: int, seq: int) -> Mesh:
    """2-D (data, seq) mesh over every rank; data*seq must be the world
    size."""
    return make_mesh_2d(data, seq)
