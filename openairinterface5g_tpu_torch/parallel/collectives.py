"""The ``jax.lax`` collectives that parallel/ uses, over one mesh axis.

Each runs on every rank of the axis's group (SPMD, as under
``shard_map``) and returns what ``jax.lax`` returns on that device.  They
are plain PyTorch over ``torch.distributed``: NCCL's collectives on the
cards, gloo's on the CPU; no kernel of the port's own.  Complex tensors
travel as ``torch.view_as_real`` views and bool tensors as uint8.

An axis is a mesh dimension's name, or a tuple of names flattened in order
(mesh.py); a tuple must name every dimension of a mesh that spans the
whole group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import _names, axis_index, axis_size

__all__ = ["axis_index", "axis_size", "psum", "pmean", "ppermute", "all_gather",
           "all_to_all"]


def _group(mesh: DeviceMesh, axis):
    names = _names(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if names != tuple(mesh.mesh_dim_names) or mesh.size() != dist.get_world_size():
        raise ValueError(f"axis {axis}: a flattened axis names every dimension of a mesh "
                         f"over the whole group, have {mesh.mesh_dim_names} over "
                         f"{mesh.size()} of {dist.get_world_size()} ranks")
    return dist.group.WORLD       # row-major over the mesh: group rank == flat index


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the backends carry it: complex as (..., 2) real, bool as uint8."""
    if x.is_complex():
        return torch.view_as_real(x.resolve_conj()).contiguous()
    if x.dtype == torch.bool:
        return x.contiguous().view(torch.uint8)
    return x.contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(y)
    if like.dtype == torch.bool:
        return y.view(torch.bool)
    return y


def psum(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """The sum of x over the axis, on every rank (``jax.lax.psum``)."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return y


def pmean(x: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """The mean of x over the axis, on every rank (``jax.lax.pmean``)."""
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: for each (src, dst) of `perm` (axis indices),
    rank dst gets src's x; a rank no pair targets gets zeros.

    One ``batch_isend_irecv`` posts every send and receive of this rank:
    both ends of a pair must post theirs, or the ranks wait for ever.  A
    pair (i, i) is a local copy: a send to one's own rank fails.
    """
    g = _group(mesh, axis)
    me = axis_index(mesh, axis)
    src = _wire(x)
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(g, d), g))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(g, s), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _unwire(out, x)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis, axis_dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's x in axis order, stacked on a new
    dimension at `axis_dim`, or with `tiled` concatenated along it."""
    g = _group(mesh, axis)
    src = _wire(x)
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=g)
    parts = [_unwire(p, x) for p in parts]
    return torch.cat(parts, dim=axis_dim) if tiled else torch.stack(parts, dim=axis_dim)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis, split_axis: int, concat_axis: int,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: x's `split_axis` in n equal chunks, chunk j to
    rank j; the chunks received, in axis order, along `concat_axis` (one
    ``all_to_all_single``).  Without `tiled` the split axis has size n and
    goes, and the received chunks stack on a new axis at `concat_axis`."""
    n = axis_size(mesh, axis)
    if x.shape[split_axis] % n or (not tiled and x.shape[split_axis] != n):
        raise ValueError(f"all_to_all: split axis of size {x.shape[split_axis]} over {n} ranks")
    src = _wire(torch.movedim(x, split_axis, 0))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=_group(mesh, axis))
    y = _unwire(out, x)                 # (n * chunk, ...): rank i's chunk at i
    chunks = y.reshape(n, y.shape[0] // n, *y.shape[1:])
    if not tiled:
        chunks = chunks[:, 0]           # (n, rest...) with the split axis gone
        return torch.movedim(chunks, 0, concat_axis)
    chunks = torch.movedim(chunks, 1, split_axis + 1)     # (n, x's shape with chunk)
    return torch.cat(list(chunks), dim=concat_axis)
