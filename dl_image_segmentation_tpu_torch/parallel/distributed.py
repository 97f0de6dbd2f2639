"""Joining a ``torch.distributed`` world, and this rank's place in it.

A port of the JAX package's ``parallel/distributed.py``. There one
process drives every chip of its host and ``jax.distributed`` joins the
hosts; here each rank is one process with one device, and the world is
a ``torch.distributed`` process group: NCCL between cards, gloo on the
CPU (``device="cpu"``) or where the caller asks for it (two ranks on one
card: NCCL refuses a card that two ranks share).

``initialize()`` reads the JAX package's variables
(``DLSEG_NUM_PROCESSES``, ``COORDINATOR_ADDRESS`` or
``JAX_COORDINATOR_ADDRESS``, ``DLSEG_PROCESS_ID``) and torchrun's
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``,
``LOCAL_RANK``); with neither it is a no-op, so the same entry point
runs in one process and in a world.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["collective_device", "initialize", "is_primary", "local_device",
           "local_rank", "rank", "world_size"]


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def _coordinator() -> Optional[str]:
    """host:port of the world's rendezvous from the environment."""
    for name in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        if os.environ.get(name):
            return os.environ[name]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> None:
    """Join the world that the arguments or the environment name; a
    no-op when there is one process and no coordinator, or when this
    process is in a world already. ``backend`` defaults to ``"gloo"``
    for ``device="cpu"`` and to ``"nccl"`` otherwise (which needs a
    card: without one this raises, as every entry point does without
    ``device="cpu"``). On the card the rank's device is made current
    first (:func:`local_device`)."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = _env_int("DLSEG_NUM_PROCESSES", "WORLD_SIZE")
    if coordinator_address is None:
        coordinator_address = _coordinator()
    if process_id is None:
        process_id = _env_int("DLSEG_PROCESS_ID", "RANK")
    if num_processes in (None, 1) and coordinator_address is None:
        return  # one process
    if num_processes is None or process_id is None \
            or coordinator_address is None:
        raise ValueError(
            "a world needs its size, this process's rank and a "
            "coordinator's host:port: set DLSEG_NUM_PROCESSES, "
            "DLSEG_PROCESS_ID and COORDINATOR_ADDRESS (or torchrun's "
            f"WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT); got "
            f"num_processes={num_processes}, process_id={process_id}, "
            f"coordinator_address={coordinator_address!r}")
    cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    if not cpu:
        dev = local_device(device, local_rank(process_id))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def rank() -> int:
    """This process's rank in the world (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks in the world (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank(global_rank: Optional[int] = None) -> int:
    """This rank's index on its host: ``LOCAL_RANK`` where torchrun set
    it, else the rank modulo the host's cards."""
    value = _env_int("LOCAL_RANK")
    if value is not None:
        return value
    r = rank() if global_rank is None else global_rank
    return r % max(1, torch.cuda.device_count())


def local_device(device=None, index: Optional[int] = None) -> torch.device:
    """The device of this rank: ``device`` when given; in a world
    ``cuda:<local rank>`` (not ``cuda:0``); else the card. Raises
    without a card unless ``device="cpu"``."""
    if device is not None:
        return resolve_device(device)
    if index is None and dist.is_initialized():
        index = local_rank()
    if index is None:
        return resolve_device(None)
    return resolve_device(f"cuda:{index}")


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return rank() == 0


def collective_device(device) -> torch.device:
    """Where a tensor that the world's default group broadcasts lives:
    ``device`` under NCCL, which moves CUDA tensors; the CPU under gloo,
    which moves CPU tensors, also for ranks that share a card."""
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return torch.device("cpu")
    return torch.device(device)
