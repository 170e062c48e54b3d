"""T1 and T2: the launch-cost probes of tools/bench_overhead.py as CUDA kernels.

``tiny`` (T1) computes ``x * 2`` on one (8, 128) f32 tile in one block;
``tiny_grid`` (T2) the same on (8, 8, 128) over a grid of 8 blocks
(``csrc/tiny.cu``).  Their work is negligible, so their time on the card is
the fixed cost of one kernel launch.  A CPU tensor takes ``tiny_plain``.
"""
from __future__ import annotations

import torch

from . import _cuda

# one count per kernel, raised where it is launched (CUDA tensors only)
launches = {"tiny": 0, "tiny_grid": 0}

_SHAPES = {"tiny": (8, 128), "tiny_grid": (8, 8, 128)}


def tiny_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of both probes."""
    return x * 2.0


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return tiny_plain(x)
    _cuda.require(x.is_cuda, f"{name}: tensor on {x.device}, not CUDA or CPU")
    _cuda.require(tuple(x.shape) == _SHAPES[name] and x.dtype == torch.float32,
                  f"{name}: need f32 {_SHAPES[name]}, got {x.dtype} {tuple(x.shape)}")
    _cuda.require(x.is_contiguous(), f"{name}: x must be contiguous")
    out = torch.empty_like(x)
    n_blocks = x.numel() // (8 * 128)
    with torch.cuda.device(x.device):
        rc = _cuda.library().tiny_times_two(x.data_ptr(), out.data_ptr(), n_blocks,
                                            _cuda.stream_ptr(x.device))
    _cuda.check(rc, name)
    launches[name] += 1
    return out


def tiny(x: torch.Tensor) -> torch.Tensor:
    """T1: (8, 128) f32 -> x * 2, one block."""
    return _launch("tiny", x)


def tiny_grid(x: torch.Tensor) -> torch.Tensor:
    """T2: (8, 8, 128) f32 -> x * 2, a grid of 8 blocks."""
    return _launch("tiny_grid", x)
