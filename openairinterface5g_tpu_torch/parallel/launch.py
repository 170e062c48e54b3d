"""Start N ranks, run one function on each, return their results.

JAX's multi-device functions are called once, from one controller; here
every rank runs its own process.  ``spawn`` gives a single-controller
caller (the tests, the dry run, a smoke script) JAX's view: it starts
`world` ranks with ``torch.multiprocessing`` (spawn context), joins them
into one group through a ``file://`` store in a fresh temporary directory
(so concurrent callers never share a port), runs ``fn(*args)`` on each and
returns the ranks' results in rank order, tensors moved to the CPU.

``run_calls`` is such a function: it runs a list of SPMD calls, each on a
mesh built in the rank, with arguments given globally and sharded in the
rank (``Shard``), as JAX's ``shard_map`` takes its ``in_specs``.

`fn` must be importable by the child processes, which start from a fresh
interpreter: a function of this package, not of a test module.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from . import mesh as mesh_mod
from .multihost import TIMEOUT_S, join, rank_device


def spawn(fn: Callable, world: int, device: str = "cuda", args: tuple = (),
          timeout_s: float = TIMEOUT_S) -> list:
    """``fn(*args)`` on each of `world` ranks; the results in rank order.

    device 'cuda': one rank per card, over NCCL; more ranks than cards
    raises before anything starts (NCCL refuses two ranks on one card).
    device 'cpu': gloo, each rank on one intra-op thread.  An exception
    in any rank ends the others, and a RuntimeError here names the rank
    that raised first, with its traceback (the others' errors, such as a
    peer's reset connection, follow from it); so does a collective that
    waits longer than `timeout_s`.
    """
    if device == "cuda":
        if not torch.cuda.is_available() or world > torch.cuda.device_count():
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"{world} ranks need {world} CUDA devices, have {n}")
    elif device != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    with tempfile.TemporaryDirectory(prefix="oai5g_spawn_") as tmp:
        # the arguments travel in a file, not through torch.multiprocessing's
        # shared-memory tensors
        torch.save(args, os.path.join(tmp, "args.pt"))
        try:
            mp.start_processes(_rank_main, args=(fn, world, device, tmp, timeout_s),
                               nprocs=world, join=True, start_method="spawn")
        except ProcessException as e:
            raise RuntimeError(_first_error(tmp) or str(e)) from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]


def _first_error(tmp: str) -> str | None:
    """The traceback of the rank that raised first, by the host's monotonic
    clock (each failing rank writes rank<r>.err before it exits; one ended
    while it wrote is skipped)."""
    errs = []
    for name in os.listdir(tmp):
        if name.endswith(".err"):
            with open(os.path.join(tmp, name)) as f:
                t, _, text = f.read().partition("\n")
            try:
                errs.append((float(t), name.removesuffix(".err"), text))
            except ValueError:
                continue
    if not errs:
        return None
    t, rank, text = min(errs)
    return f"{rank} raised first ({len(errs)} rank(s) failed):\n{text}"


def _rank_main(rank: int, fn: Callable, world: int, device: str, tmp: str,
               timeout_s: float) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    join(f"file://{os.path.join(tmp, 'store')}", world, rank, device, timeout_s=timeout_s)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.monotonic()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Shard:
    """A global argument of which each rank gets its block of the leading
    dimension along `axis` (``mesh.shard_batch``)."""
    value: Any
    axis: Any = "dp"


MESH = "<mesh>"      # an argument of a Call that stands for the call's mesh


@dataclasses.dataclass(frozen=True)
class Call:
    """One SPMD call for ``run_calls``: `fn` (a function of this package) on a mesh
    of `shape` with `names` (1-D: ``make_mesh``; ("dp", "cb"):
    ``make_mesh_2d``), the mesh passed where an argument is MESH."""
    fn: Callable
    shape: tuple
    names: tuple
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)


def run_calls(calls: list) -> list:
    """On each rank: every Call in turn, each Shard argument replaced by
    this rank's block, MESH by the call's mesh (one mesh per shape and
    names, built by every rank), every tensor moved to the rank's device;
    per call its result, or None where this rank lies outside the mesh."""
    meshes, out, dev = {}, [], rank_device()
    for c in calls:
        key = (tuple(c.shape), tuple(c.names))
        if key not in meshes:
            meshes[key] = (mesh_mod.make_mesh_2d(*c.shape) if c.names == ("dp", "cb")
                           else mesh_mod.make_mesh(c.shape[0], c.names[0]))
        m = meshes[key]
        if m.get_coordinate() is None:
            out.append(None)
            continue

        def arg(a):
            if isinstance(a, Shard):
                return mesh_mod.shard_batch(m, arg(a.value), a.axis)
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return m if isinstance(a, str) and a == MESH else a

        out.append(c.fn(*map(arg, c.args), **{k: arg(v) for k, v in c.kwargs.items()}))
    return out
