"""Joining a torch.distributed group (port of
openairinterface5g_tpu/parallel/multihost.py).

The reference splits RU/L1 across hosts over fronthaul Ethernet and
MAC/PHY over nFAPI UDP (SURVEY.md C7/C8).  In JAX both become a bigger
mesh joined by ``jax.distributed``; here every rank is one process with
one card, joined into a ``torch.distributed`` group: NCCL on the cards,
gloo only where the caller asks for the CPU.  The programs of
``sharded.py`` and ``pusch_sp.py`` then run unchanged on every rank.

A launcher stays thin: under ``torchrun`` the defaults come from its
environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), as
JAX's come from JAX_COORDINATOR_ADDRESS.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

TIMEOUT_S = 120.0      # a collective that waits longer fails its rank


def join(init_method: str, world: int, rank: int, device: str = "cuda",
         local_rank: int | None = None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the group at `init_method` (``tcp://host:port``, ``file://path``
    or ``env://``) as `rank` of `world`; returns the rank's device.

    device 'cuda': the rank takes card `local_rank` (default: `rank`), set
    as the current device before NCCL starts; without CUDA or NCCL this
    raises, it never falls back to gloo.  device 'cpu': gloo.
    """
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a card's rank needs one (device='cpu' "
                               "runs the group on gloo)")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: a card's rank needs it")
        dev = torch.device("cuda", rank if local_rank is None else local_rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s), device_id=dev)
        return dev
    if device != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return torch.device("cpu")


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, local_rank: int | None = None,
                   device: str = "cuda") -> None:
    """Join the torch.distributed group (a no-op if one exists already or
    no coordinator is given).

    coordinator is ``host:port``; without it the group is found through
    MASTER_ADDR and MASTER_PORT (``env://``, which under torchrun joins its
    agent's store).  num_processes is the world size (default WORLD_SIZE),
    process_id the rank (RANK), local_rank the card on this host
    (LOCAL_RANK).  See ``join`` for `device`.
    """
    env = os.environ
    if dist.is_initialized() or not (coordinator or "MASTER_ADDR" in env):
        return
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if local_rank is None and "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])
    join(f"tcp://{coordinator}" if coordinator else "env://", world, rank, device, local_rank)


def device_type() -> str:
    """The group's device type: 'cuda' under NCCL, else 'cpu'."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def rank_device() -> torch.device:
    """This rank's device: its current card under NCCL, else the CPU."""
    if device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(axis: str = "dp") -> DeviceMesh:
    """1-D mesh over every rank of the (possibly multi-host) group."""
    return init_device_mesh(device_type(), (dist.get_world_size(),), mesh_dim_names=(axis,))
