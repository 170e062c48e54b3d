#!/usr/bin/env python3
"""K3, the fused PUSCH frontend, on one GPU: its device time at the main
path's tensors and at 20 PRB, and how that time splits.

    python -m openairinterface5g_tpu_torch.tools.bench_frontend [--clusters]

Rows (``pusch_frontend.frontend_planes``, B = 8 slots):
  main     the main path's RE grid: 273 PRB, 2 layers, 2 RX, MCS 16
           (``bench_launch.receiver``)
  prb20    20 PRB, same layers, antennas and MCS, a random TB grid through
           a random 2x2 channel and AWGN

Each row is first held against ``frontend_planes_plain`` (2e-4 of
max|LLR|), so a wrong kernel is never timed, then gives per call:
  rows       device ms of each of K3's CUDA kernels, torch.profiler rows
             (mean over CALLS calls after the profiler's warm-up step);
             the keys match both the one-launch kernel (``frontend_kernel``)
             and a two-launch checkout's (``estimate_kernel``,
             ``equalize_llr_kernel``)
  device_ms  their sum
  events_ms  CUDA events around back-to-back calls (the host's enqueue
             where that is the slower side)
  graph_ms   one replay of a CUDA graph of CALLS captured calls, per call
             (median of REPLAYS replays): the device alone, so
             gaps_ms = graph_ms - device_ms is the time between kernels on
             the device (two launches: the gap between them, and one to
             the next call's first)
and, for the main row, host_us (the wrapper's enqueue per call) and
in_torch_mul_calls (that over torch.mul(x, 2)'s host µs in the same
window, median of WINDOWS windows): the host cost in units that hold
across processes; ``alternating`` is the same with calls that alternate
between the main path's configuration and 20 PRB (two plans in turn).

``--clusters`` times instead the device ms (profiler rows) of this
checkout's kernel at each cluster size whose shape fits, at 6, 20, 51,
106, 160 and 273 PRB with B = 8 and at 273 PRB with B = 1 and 40 (2x2,
MCS 16): the measurement behind the plan's choice of cluster size.

It prints one JSON line.  The port is imported by absolute name and, for
the rows, through its public entry points only, so this file also times
another checkout of the port, such as a parent commit:

    cd <checkout> && PYTHONPATH=$PWD python <path of this file>

Alternating pairs of such processes (parent, change, change, parent, ...)
in one run compare two versions on the same card.

Without CUDA it raises: these are device measurements.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics

import torch

from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
from openairinterface5g_tpu_torch.tools import bench_launch, bench_ldpc_layered

CALLS = 20
REPLAYS = 5
WINDOWS = 9
TOL = 2e-4                 # max |kernel - plain| / max |plain| of the planes
B = bench_launch.MAIN_PATH_B
# K3's CUDA kernels, as torch.profiler names them, in any checkout
KEYS = ("frontend_kernel", "estimate_kernel", "equalize_llr_kernel")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|; raises on a shape or a non-finite value."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K3: shape {tuple(got.shape)} against {tuple(ref.shape)}, "
                             f"or non-finite")
    return float((got - ref).abs().max() / ref.abs().max())


def kernel_rows(found: dict, calls: int) -> dict:
    """key -> device ms per call, of the keys that have profiler rows
    (`found`: key -> (summed µs, count) over `calls` calls); raises unless
    at least one key has rows and every key that has them ran once a call."""
    present = {k: v for k, v in found.items() if v[1]}
    if not present or any(n != calls for _, n in present.values()):
        raise AssertionError(f"profiler recorded {found} in {calls} calls")
    return {k: us / n / 1e3 for k, (us, n) in present.items()}


def rows_ms(fn, calls: int = CALLS, attempts: int = 5) -> dict:
    """kernel_rows of fn, a profile retaken where it missed a launch."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        found = bench_ldpc_layered.profiled_rows(fn, calls, KEYS)
        try:
            return kernel_rows(found, calls)
        except AssertionError:
            continue
    return kernel_rows(found, calls)


def graph_ms(fn, calls: int = CALLS, replays: int = REPLAYS) -> float:
    """Device ms per call of fn captured `calls` times in one CUDA graph:
    the median over `replays` replays."""
    graph = bench_launch.capture(fn, calls)
    return statistics.median(bench_launch.replay_ms(graph, calls) for _ in range(replays))


def summary(rows: dict, events: float, graph: float) -> dict:
    device = sum(rows.values())
    return {"rows": rows, "device_ms": device, "events_ms": events, "graph_ms": graph,
            "gaps_ms": graph - device}


def measure(cfg, re_grid: torch.Tensor) -> dict:
    """One row: K3 held against its plain version, then timed."""
    err = rel_err(fe.frontend_planes(cfg, re_grid), fe.frontend_planes_plain(cfg, re_grid))
    if not err < TOL:
        raise AssertionError(f"K3 at {cfg.n_prb} PRB: relative error {err:.3e} >= {TOL}")

    def k3():
        return fe.frontend_planes(cfg, re_grid)

    out = summary(rows_ms(k3), bench_launch.events_ms(k3, CALLS), graph_ms(k3))
    out["rel_err"] = err
    return out


def grid(cfg, dev, gen, slots: int = B, noise: float = 0.05) -> torch.Tensor:
    """A received RE grid: random TBs through pusch_tx_grid, a random
    n_rx x n_layers channel and complex AWGN."""
    tb = torch.randint(0, 2, (slots, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    grid_re, _ = pusch.pusch_tx_grid(cfg, tb)
    shape = (cfg.n_rx, cfg.n_layers)
    h = torch.complex(torch.randn(shape, generator=gen, device=dev),
                      torch.randn(shape, generator=gen, device=dev)) / 2 ** 0.5
    y = torch.einsum("rl,blsm->brsm", h, grid_re)
    n = torch.complex(torch.randn(y.shape, generator=gen, device=dev),
                      torch.randn(y.shape, generator=gen, device=dev))
    return (y + noise * n).contiguous()


def host_in_torch_mul_calls(fn, x: torch.Tensor, windows: int = WINDOWS) -> dict:
    """The wrapper's enqueue µs per call and torch.mul(x, 2)'s, medians over
    windows, and the median over windows of their ratio."""
    k3, mul = [], []
    for _ in range(windows):
        k3.append(bench_launch.host_us(fn, 100))
        mul.append(bench_launch.host_us(lambda: torch.mul(x, 2)))
    return {"host_us": statistics.median(k3), "torch_mul_us": statistics.median(mul),
            "in_torch_mul_calls": statistics.median(a / b for a, b in zip(k3, mul))}


def alternate(*fns):
    """One function that calls fns in turn, one per call."""
    turn = itertools.cycle(fns)
    return lambda: next(turn)()


# (label, PRB, slots) of the cluster-size sweep
SWEEP = (("prb6", 6, B), ("prb20", 20, B), ("prb51", 51, B), ("prb106", 106, B),
         ("prb160", 160, B), ("main", 273, B), ("main_b1", 273, 1), ("main_b40", 273, 40))


def clusters(dev, gen) -> dict:
    """Per SWEEP row, at each cluster size that fits (every one of
    ``cluster_sizes``, not only the plan's): device ms per call and the
    clusters the card holds resident at once; and the planned size."""
    out = {}
    for label, n_prb, slots in SWEEP:
        cfg = pusch.PuschConfig(mu=1, n_prb=n_prb, mcs=16, n_layers=2, n_rx=2)
        y = grid(cfg, dev, gen, slots)
        ref = fe.frontend_planes_plain(cfg, y)
        row = {"ms": {}, "active": {}}
        for c in fe.cluster_sizes(n_prb):
            shape = fe.shape_of(c, cfg.n_rx, cfg.n_layers, 6 * n_prb, len(cfg.dmrs_symbols),
                                len(cfg.data_symbols), cfg.chest_window)
            if shape is None:
                continue
            err = rel_err(fe._launch(cfg, y, C=c), ref)
            if not err < TOL:
                raise AssertionError(f"K3 at {n_prb} PRB, C = {c}: relative error {err:.3e}")
            row["ms"][c] = sum(rows_ms(lambda c=c: fe._launch(cfg, y, C=c)).values())
            row["active"][c] = fe._active_clusters(cfg.n_layers, cfg.qm_rate[0], shape,
                                                   dev.index)
        row["planned"] = fe._plan(cfg, dev).shape.C
        out[label] = row
    return out


def run(sweep: bool = False) -> dict:
    """The rows above, or with `sweep` the cluster sizes; prints one JSON line."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_frontend measures K3 on a GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"device": torch.cuda.get_device_name(dev), "calls": CALLS}
    if sweep:
        out["clusters"] = clusters(dev, gen)
        print(json.dumps(out))
        return out
    rcv = bench_launch.receiver(dev, gen)
    out["main"] = measure(rcv.cfg, rcv.re_grid)
    cfg20 = pusch.PuschConfig(mu=1, n_prb=20, mcs=16, n_layers=2, n_rx=2)
    y20 = grid(cfg20, dev, gen)
    out["prb20"] = measure(cfg20, y20)
    ones = torch.ones((8, 128), device=dev)
    out["main"].update(host_in_torch_mul_calls(
        lambda: fe.frontend_planes(rcv.cfg, rcv.re_grid), ones))
    out["alternating"] = host_in_torch_mul_calls(
        alternate(lambda: fe.frontend_planes(rcv.cfg, rcv.re_grid),
                  lambda: fe.frontend_planes(cfg20, y20)), ones)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="K3's device time on one GPU")
    ap.add_argument("--clusters", action="store_true",
                    help="time each cluster size that fits instead of the rows")
    run(ap.parse_args().clusters)
