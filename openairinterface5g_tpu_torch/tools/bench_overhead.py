#!/usr/bin/env python3
"""Fixed per-step and per-launch costs on one GPU.

    python -m openairinterface5g_tpu_torch.tools.bench_overhead

Port of tools/bench_overhead.py's probes, each over R = 8 steps (the
original's ``scan`` is a Python loop here):

  a) trivial step, no kernel of the port: c + sum(x * 2 + 1) on 1M f32
  b) T1 ``tiny`` (x * 2 on (8, 128) f32, one block) per step
  d) two T1 launches per step
  e) T2 ``tiny_grid`` (x * 2 on (8, 8, 128), a grid of 8 blocks) per step
  c) K1, layered f32, BG1 Z=384, 112 code blocks, 8 iterations: R calls
     enqueued back to back (pipelined dispatch)

Each line gives ms per step twice: by the host clock around the R steps
and a closing synchronize (what the original measured: dispatch included)
and by CUDA events on the device stream.  ``--device cpu`` runs the plain
versions and prints the host clock only (not a device time).  Without CUDA
and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..coding import ldpc
from ..ops import ldpc_decoder, tiny

R = 8


def _timeit(label: str, step, xs, cuda: bool) -> dict:
    """Warm up, then time R steps of `step` over xs[i]."""
    c = torch.zeros((), device=xs[0].device)
    for i in range(R):
        c = c + step(xs[i])
    float(c)
    if cuda:
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
    t0 = time.perf_counter()
    c = torch.zeros((), device=xs[0].device)
    for i in range(R):
        c = c + step(xs[i])
    if cuda:
        e1.record()
    float(c)                                   # fetch: synchronizes
    host_ms = (time.perf_counter() - t0) * 1e3 / R
    dev_ms = e0.elapsed_time(e1) / R if cuda else None
    dev = f"{dev_ms:8.3f} ms/step events" if cuda else "(cpu, host clock only)"
    print(f"{label:46s} {host_ms:8.3f} ms/step host  {dev}")
    return {"probe": label, "host_ms": host_ms, "device_ms": dev_ms}


def run(device: str = "cuda", cbs: int = 112) -> list[dict]:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a GPU, or pass --device cpu "
                           "for the plain versions")
    print(f"device: {torch.cuda.get_device_name(dev) if cuda else 'cpu (plain versions)'}")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    out = []
    xs = t(rng.normal(size=(R, 1024, 1024)))
    out.append(_timeit("a trivial step (1M f32 elementwise)",
                       lambda x: torch.sum(x * 2.0 + 1.0), xs, cuda))
    xs_t = t(rng.normal(size=(R, 8, 128)))
    out.append(_timeit("b T1 tiny per step", lambda x: torch.sum(tiny.tiny(x)), xs_t, cuda))
    out.append(_timeit("d two T1 tiny per step",
                       lambda x: torch.sum(tiny.tiny(x)) + torch.sum(tiny.tiny(x + 1.0)),
                       xs_t, cuda))
    xs_g = t(rng.normal(size=(R, 8, 8, 128)))
    out.append(_timeit("e T2 tiny_grid (grid=8) per step",
                       lambda x: torch.sum(tiny.tiny_grid(x)), xs_g, cuda))

    g = ldpc.build_graph(1, 384)
    ls = t(rng.normal(size=(R, cbs, g.cols * g.Z)) * 8)

    def one(l):
        bits, ok = ldpc_decoder.decode(g, l, 8)
        return (ok.sum() + bits.sum(dtype=torch.int64)).float()

    out.append(_timeit(f"c ldpc {cbs}cb x8it pipelined dispatch", one, ls, cuda))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
