"""The multi-process bootstrap (counterpart of scldm_tpu/parallel/distributed.py).

One process drives one card, so a rank here is what a JAX process is there:
each rank loads its own rows of the global batch (the DataModule's host
split), and the steps' collectives join the ranks. JAX's one-process,
many-device layout has no counterpart.

`maybe_initialize_distributed` starts `torch.distributed` where the
environment says this process is one of several:

- torchrun's variables: `RANK`, `WORLD_SIZE` > 1, `LOCAL_RANK`, `MASTER_ADDR`
  and `MASTER_PORT` (`torchrun --nproc_per_node=N -m scldm_torch.cli.train`);
- JAX's explicit triple: `JAX_COORDINATOR_ADDRESS` (host:port),
  `JAX_NUM_PROCESSES` > 1 and `JAX_PROCESS_ID`, mapped onto the same init
  (`LOCAL_RANK` where set, else the rank modulo the cards).

The backend is NCCL on the card and gloo on the CPU. On the card the rank
binds `LOCAL_RANK`'s device; NCCL without a card, or without NCCL, raises:
nothing falls back to gloo or to one process.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from scldm_torch.utils.logger import logger

_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_JAX = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def _launch_env():
    """(rank, world, local rank, init_method) from the environment, or None
    for one process."""
    env = os.environ
    if all(env.get(k) for k in _TORCHRUN) and int(env["WORLD_SIZE"]) > 1:
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"]), "env://"
    if all(env.get(k) for k in _JAX) and int(env["JAX_NUM_PROCESSES"]) > 1:
        rank = int(env["JAX_PROCESS_ID"])
        local = env.get("LOCAL_RANK")
        if local is None:
            local = rank % max(torch.cuda.device_count(), 1)
        return (rank, int(env["JAX_NUM_PROCESSES"]), int(local),
                f"tcp://{env['JAX_COORDINATOR_ADDRESS']}")
    return None


def maybe_initialize_distributed(device: Optional[str] = None) -> bool:
    """Start the process group where the environment names several
    processes (the module docstring). `device` is the config's device
    (default cuda): NCCL there, gloo on the CPU. Returns True if a process
    group is (now) up, False for one process. Calling it again does
    nothing."""
    if dist.is_available() and dist.is_initialized():
        return True
    launch = _launch_env()
    if launch is None:
        return False
    rank, world, local, init_method = launch
    device = torch.device(device or "cuda")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not (torch.cuda.is_available() and dist.is_nccl_available()):
        raise RuntimeError(f"rank {rank} of {world}: NCCL needs a CUDA device and a NCCL build of "
                           "torch; pass device=cpu to train over gloo on the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    if rank > 0:
        logger.setLevel(logging.WARNING)  # the log is rank 0's
    logger.info(f"torch.distributed up: {world} ranks over {backend}")
    return True


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def collective_device() -> torch.device:
    """Where the small tensors of a collective live: the bound card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every rank waits for the others (nothing without a process group)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def spans_nodes() -> bool:
    """Whether the ranks run on more than one machine (torchrun's
    `LOCAL_WORLD_SIZE` below the world size)."""
    world = world_size()
    return world > 1 and int(os.environ.get("LOCAL_WORLD_SIZE", world)) < world


def sync_generator_(generator: torch.Generator, group) -> None:
    """Every rank of `group` takes the state of the group's first rank's
    `generator`, so the ranks that share rows draw what one process draws."""
    state = [generator.get_state()]
    dist.broadcast_object_list(state, src=dist.get_global_rank(group, 0), group=group)
    generator.set_state(state[0])
