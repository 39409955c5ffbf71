"""Process-group start-up from the environment (counterpart of
`ssd3d/parallel/distributed.py`).

The port trains on several cards with one process a card over
`torch.distributed`: NCCL on the card, gloo when the caller asks for the
CPU. Every process of a run sets the JAX package's contract:

    SSD3D_DIST_COORDINATOR   host:port of process 0 (init_method tcp://...)
    SSD3D_DIST_NUM_PROCESSES total process count
    SSD3D_DIST_PROCESS_ID    this process's rank

or SSD3D_DIST_AUTO=1 under a launcher that sets torch's own variables
(torchrun: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK; init_method
env://). A rank takes card LOCAL_RANK where the launcher sets it, else its
process id modulo the cards of its host, and makes it the current device
before anything is built or launched on it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def world() -> int:
    """Ranks of the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _contract() -> tuple[str, int, int] | None:
    """(init_method, world size, rank) from the environment, or None."""
    if os.environ.get("SSD3D_DIST_AUTO"):
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if os.environ.get("SSD3D_DIST_COORDINATOR"):
        return (f"tcp://{os.environ['SSD3D_DIST_COORDINATOR']}",
                int(os.environ["SSD3D_DIST_NUM_PROCESSES"]),
                int(os.environ["SSD3D_DIST_PROCESS_ID"]))
    return None


def initialize_from_env(log=print, device: torch.device | str = "cuda") -> bool:
    """Start the default process group from the SSD3D_DIST_* contract:
    NCCL when `device` is the card (after making this rank's card current),
    gloo on the CPU. Returns True when this call started a group; False
    without the contract or when a group already exists."""
    spec = _contract()
    if spec is None or dist.is_initialized():
        return False
    init_method, size, r = spec
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init_method, world_size=size, rank=r,
                                device_id=torch.device("cuda", local))
        where = f"card {local} ({torch.cuda.get_device_name(local)})"
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=size, rank=r)
        where = "the CPU"
    log(f"distributed: process {r}/{size} on {where}, backend {dist.get_backend()}")
    return True


def rank_device(device: torch.device | str) -> torch.device:
    """This rank's device: the current card for "cuda" (the one
    `initialize_from_env` made current), else `device` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
