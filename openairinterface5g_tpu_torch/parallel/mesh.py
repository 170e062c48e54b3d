"""Device meshes and shards (port of openairinterface5g_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed`` DeviceMesh with JAX's axis names over
the first ranks of the group, in JAX's order: ``make_mesh_2d(dp, cb)``
puts rank r at (r // cb, r % cb), as JAX reshapes its device list
row-major.  Every rank of the group must build every mesh (building one
creates its process groups); a rank outside a smaller mesh gets no
coordinate on it and takes no part in its collectives.

An axis is one mesh dimension's name, or a tuple of names that flattens
those dimensions in order, as JAX's ``P(("dp", "cb"))`` does.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .multihost import device_type


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> DeviceMesh:
    """1-D mesh over the first `n_devices` ranks (default: all)."""
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(dp: int, cb: int) -> DeviceMesh:
    """(dp, cb) mesh over the first dp * cb ranks, row-major."""
    return init_device_mesh(device_type(), (dp, cb), mesh_dim_names=("dp", "cb"))


def _names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """Ranks along `axis` (the product of the flattened dimensions)."""
    return math.prod(mesh.shape[mesh.mesh_dim_names.index(a)] for a in _names(axis))


def axis_index(mesh: DeviceMesh, axis) -> int:
    """This rank's index along `axis`, row-major over flattened dimensions
    (``jax.lax.axis_index``)."""
    i = 0
    for a in _names(axis):
        i = i * mesh.shape[mesh.mesh_dim_names.index(a)] + mesh.get_local_rank(a)
    return i


def shard_batch(mesh: DeviceMesh, x: torch.Tensor, axis="dp") -> torch.Tensor:
    """This rank's contiguous block of x's leading dimension: the shard that
    JAX's ``NamedSharding(mesh, P(axis))`` places on this rank's device."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading dimension {x.shape[0]} does not divide over {n} ranks")
    blk = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * blk:(i + 1) * blk]
