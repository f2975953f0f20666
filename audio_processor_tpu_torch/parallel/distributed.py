"""Multi-process bootstrap and call sharding (port of
parallel/distributed.py).

PyTorch runs one process per device with explicit collectives, where JAX
runs one controller per host. A launch names its processes either the
torchrun way (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) or the JAX package's way (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so a launch script written for
the reference starts the port too. The process index is the rank and the
process count is the world size.

Host-side stages that must run once per run are gated on
:func:`is_primary_host`; calls are sharded across processes by call-id
hash (:func:`owns_call`), the same hash as the reference's, so a call lands
on the same rank in both packages.
"""

from __future__ import annotations

import datetime
import logging
import os
import zlib
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# How long a rank waits for the others at bootstrap and in a collective.
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def _launch_from_env(coordinator_address, num_processes, process_id):
    """(init_method, world size, rank) from the arguments or the launch's
    environment; None when nothing names a coordinator."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is not None:
        world = num_processes or _env_int("JAX_NUM_PROCESSES")
        rank = process_id if process_id is not None \
            else _env_int("JAX_PROCESS_ID")
        if world is None:
            raise ValueError(
                f"coordinator {coordinator_address!r} without a process "
                "count: set JAX_NUM_PROCESSES (or pass num_processes)")
        if rank is None and world > 1:
            raise ValueError(
                f"coordinator {coordinator_address!r} with {world} processes "
                "but no process id: set JAX_PROCESS_ID (or pass process_id)")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        return init, int(world), int(rank or 0)
    world = num_processes or _env_int("WORLD_SIZE")
    if world is None:
        return None
    rank = process_id if process_id is not None else _env_int("RANK")
    if world > 1 and (rank is None or not os.environ.get("MASTER_ADDR")):
        raise ValueError(
            f"WORLD_SIZE={world} without RANK and MASTER_ADDR/MASTER_PORT "
            "(launch with torchrun, or set them)")
    return "env://", int(world), int(rank or 0)


def local_world_size(world: Optional[int] = None) -> int:
    """Processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else the
    whole world (a launch without it is taken to be one host)."""
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    return world if world is not None else process_count()


def local_rank(rank: Optional[int] = None) -> int:
    """This process's index on its host: ``LOCAL_RANK``, else the rank
    (``rank``, or the group's)."""
    n = _env_int("LOCAL_RANK")
    if n is not None:
        return n
    return rank if rank is not None else process_index()


def local_device(kind: str = "cuda", rank: Optional[int] = None
                 ) -> torch.device:
    """The device this process runs on: ``cuda:<LOCAL_RANK>`` (modulo the
    visible cards, so ranks that share one card under ``gloo`` land on
    it), or the CPU when asked."""
    if torch.device(kind).type != "cuda":
        return torch.device(kind)
    if not torch.cuda.is_available():
        raise RuntimeError("asked for CUDA, but torch.cuda.is_available() "
                           "is False")
    return torch.device("cuda",
                        local_rank(rank) % torch.cuda.device_count())


def _pick_backend(backend: Optional[str], world: int) -> str:
    """NCCL when every process of this host has a card of its own; gloo
    only when the caller names it."""
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA device for the NCCL backend: pass backend=\"gloo\" to "
            "run the processes on the CPU")
    need = local_world_size(world)
    if torch.cuda.device_count() < need:
        raise ValueError(
            f"{need} processes on this host share "
            f"{torch.cuda.device_count()} CUDA device(s), and NCCL refuses "
            "two ranks on one device: pass backend=\"gloo\" to run them "
            "there")
    return "nccl"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the launch's process group and return this process's rank.

    Reads the arguments, else ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` (as
    ``init_method="tcp://<address>"``), else torchrun's ``WORLD_SIZE`` /
    ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``). A launch of
    one process, or none named, is a no-op that returns 0, as in the
    reference. The backend is NCCL when every process of the host has a
    card of its own; two ranks on one card raise ValueError naming
    ``backend="gloo"``, which runs only when asked for. A group that is
    already initialised is kept."""
    if dist.is_initialized():
        return dist.get_rank()
    launch = _launch_from_env(coordinator_address, num_processes, process_id)
    if launch is None or launch[1] <= 1:
        logger.info("Single-process run (no coordinator configured)")
        return 0
    init, world, rank = launch
    backend = _pick_backend(backend, world)
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda", rank))
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed initialised: process %d/%d, backend %s",
                rank, world, backend)
    return rank


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary_host() -> bool:
    return process_index() == 0


def owns_call(call_id: str) -> bool:
    """Deterministic call-id -> process assignment for sharding host-side
    work (decode, device work, DB writes) across processes."""
    n = process_count()
    if n <= 1:
        return True
    return zlib.crc32(call_id.encode()) % n == process_index()


def local_file_shard(files, sort: bool = True):
    """Partition the input file list so each process decodes only its
    share."""
    files = sorted(files) if sort else list(files)
    return files[process_index()::process_count()]
