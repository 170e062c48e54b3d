"""T1 and T2: the launch-cost probes of tools/bench_overhead.py as CUDA kernels.

``tiny`` (T1) computes ``x * 2`` on one (8, 128) f32 tile in one block;
``tiny_grid`` (T2) the same on (8, 8, 128) over a grid of 8 blocks
(``csrc/tiny.cu``).  Their work is negligible, so their time on the card is
the fixed cost of one launch through the port's route (``ops/_cuda.py``),
the route every kernel of the port takes.  A CPU tensor takes
``tiny_plain``.
"""
from __future__ import annotations

import torch

from . import _cuda

# one count per kernel, raised where it is launched (CUDA tensors only)
launches = {"tiny": 0, "tiny_grid": 0}

_SHAPES = {"tiny": (8, 128), "tiny_grid": (8, 8, 128)}
_BLOCKS = {"tiny": 1, "tiny_grid": 8}      # one (8, 128) tile per block (csrc/tiny.cu)


def tiny_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of both probes."""
    return x * 2.0


def check_args(name: str, shape, dtype: torch.dtype, contiguous: bool) -> None:
    """Raise ValueError unless the kernel takes a tensor of this shape, type
    and layout: f32 of the probe's shape, contiguous."""
    if shape != _SHAPES[name] or dtype is not torch.float32 or not contiguous:
        raise ValueError(f"{name}: need contiguous f32 {_SHAPES[name]}, got {dtype} "
                         f"{tuple(shape)}, contiguous={contiguous}")


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    check_args(name, x.shape, x.dtype, x.is_contiguous())
    r = _cuda.route()
    out = torch.empty_like(x)
    dev = x.get_device()
    rc = r.tiny_times_two(x.data_ptr(), out.data_ptr(), _BLOCKS[name], dev, r.stream(dev))
    if rc:
        raise _cuda.error(rc, name)
    launches[name] += 1
    return out


def _plain(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":
        raise ValueError(f"{name}: tensor on {x.device}, not CUDA or CPU")
    return tiny_plain(x)


def tiny(x: torch.Tensor) -> torch.Tensor:
    """T1: (8, 128) f32 -> x * 2, one block."""
    return _launch("tiny", x) if x.is_cuda else _plain("tiny", x)


def tiny_grid(x: torch.Tensor) -> torch.Tensor:
    """T2: (8, 8, 128) f32 -> x * 2, a grid of 8 blocks."""
    return _launch("tiny_grid", x) if x.is_cuda else _plain("tiny_grid", x)
