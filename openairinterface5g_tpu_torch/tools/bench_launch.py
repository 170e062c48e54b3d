#!/usr/bin/env python3
"""The cost of one kernel launch through the port's route, against PyTorch's
own dispatch, on one GPU.

    python -m openairinterface5g_tpu_torch.tools.bench_launch

T1 (``tiny``: x * 2 on (8, 128) f32) and T2 (``tiny_grid``: (8, 8, 128))
against ``torch.mul(x, 2)`` on the same tensors, taken in turns (T1, mul,
mul, T2, then the reverse order) over 15 windows, each window giving per
function:

  host_us    host clock over 1000 back-to-back calls with no sync inside,
             per call: the enqueue (synchronized before and after the
             window, outside it)
  ms         CUDA events over 200 back-to-back calls, per call: what
             chip_smoke.py has always reported, the host's enqueue wherever
             that is the slower side
  device_ms  one replay of a CUDA graph of 200 captured calls, by CUDA
             events, per call: the device alone

Then, in 15 windows, the main path (``receiver`` and ``receiver_host``,
the functions chip_smoke.py's main-path phase takes its setup and host
costs from): the host enqueue and the CUDA-event time of one ``pusch_rx``
batch, and the enqueue of one call of each of its kernel wrappers (K3
``frontend_planes``, K1 ``decode``) at its own tensors, each window also
timing ``torch.mul(x, 2)``'s host µs.

It prints one JSON line: per function and metric the median over the
windows and its range, and per kernel and main-path host cost the median
over the windows of its ratio to ``torch.mul`` in the same window.  The
host's speed moves between processes and calls on a shared machine (up to
1.6x); the ratio to ``torch.mul`` does not, so it is what compares two
checkouts.  The port is imported by absolute name and through its public
entry points only, so this file also times another checkout of the port
that has them:

    cd <checkout> && PYTHONPATH=$PWD python <path of this file>

Without CUDA it raises: these are device measurements.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import types

import torch

from openairinterface5g_tpu_torch.coding import ldpc, rate_matching
from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import ldpc_decoder, tiny
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate

WINDOWS = 15             # windows of a median here and of chip_smoke.py's probe turns
HOST_CALLS = 1000
EVENT_CALLS = 200
GRAPH_CALLS = 200
MAIN_PATH_B = 8          # slots per batch
MAIN_PATH_ITERS = 8      # LDPC iterations
MAIN_PATH_BATCHES = 20   # batches timed in a window
# each probe and the torch.mul call on the same tensor
PAIRS = {"tiny": "torch.mul (8, 128)", "tiny_grid": "torch.mul (8, 8, 128)"}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs per call over `calls` back-to-back calls of fn, no sync inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def events_ms(fn, calls: int = EVENT_CALLS) -> float:
    """ms per call by CUDA events around `calls` back-to-back calls of fn,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def capture(fn, calls: int = GRAPH_CALLS) -> torch.cuda.CUDAGraph:
    """A CUDA graph of `calls` calls of fn, warmed up on a side stream first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def replay_ms(graph: torch.cuda.CUDAGraph, calls: int = GRAPH_CALLS) -> float:
    """Device ms per captured call: one replay by CUDA events, after one
    warm-up replay."""
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def turns(fns: dict, windows: int) -> dict:
    """Every metric of every function, in turns: the order of `fns` in even
    windows, the reverse in odd ones.  -> name -> metric -> samples."""
    graphs = {name: capture(fn) for name, fn in fns.items()}
    samples = {name: {"host_us": [], "ms": [], "device_ms": []} for name in fns}
    names = list(fns)
    for w in range(windows):
        for name in (names if w % 2 == 0 else names[::-1]):
            s = samples[name]
            s["host_us"].append(host_us(fns[name]))
            s["ms"].append(events_ms(fns[name]))
            s["device_ms"].append(replay_ms(graphs[name]))
    return samples


def summary(samples: dict) -> dict:
    """name -> metric -> {median, min, max} over the windows."""
    return {name: {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                   for k, v in s.items()} for name, s in samples.items()}


def ratios(samples: dict) -> dict:
    """kernel -> metric -> median over the windows of kernel / torch.mul in
    the same window (below 1: the kernel is cheaper)."""
    return {k: {m: statistics.median(a / b for a, b in zip(samples[k][m], samples[lib][m]))
                for m in samples[k]} for k, lib in PAIRS.items()}


def probes(dev: torch.device, gen: torch.Generator) -> dict:
    """T1, T2 and torch.mul(x, 2) on the same random tensors, in the order
    of the turns: kernel, library, library, kernel."""
    x1 = torch.randn((8, 128), generator=gen, device=dev)
    x2 = torch.randn((8, 8, 128), generator=gen, device=dev)
    return {"tiny": lambda: tiny.tiny(x1), PAIRS["tiny"]: lambda: torch.mul(x1, 2),
            PAIRS["tiny_grid"]: lambda: torch.mul(x2, 2),
            "tiny_grid": lambda: tiny.tiny_grid(x2)}


def receiver(dev: torch.device, gen: torch.Generator) -> types.SimpleNamespace:
    """The main path as chip_smoke.py drives it: the 100 MHz 2x2 receiver
    (273 PRB, MCS 16, B = 8 slots, the K1 decoder with check_every=1), its
    sent TBs and received samples (the bench's channel: tx + 0.1 tx.flip(1)
    + 0.05 complex noise), and its two kernel wrappers' inputs at that
    batch: the RE grid (K3) and the graph and bf16 code-block LLRs (K1)."""
    cfg = pusch.PuschConfig(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2,
                            decoder_backend="kernel", decoder_check_every=1)
    tb = torch.randint(0, 2, (MAIN_PATH_B, cfg.tbs), generator=gen, device=dev,
                       dtype=torch.int8)
    tx, _ = pusch.pusch_tx(cfg, tb)
    noise = torch.complex(torch.randn(tx.shape, generator=gen, device=dev),
                          torch.randn(tx.shape, generator=gen, device=dev))
    rx = tx + 0.1 * tx.flip(1) + 0.05 * noise
    re_grid = extract_from_grid(cfg.fp, ofdm_demodulate(cfg.fp, rx, cfg.slot)).contiguous()
    p, _ = cfg.seg_params()
    g = ldpc.build_graph(p.bg, p.Z)
    planes = fe.frontend_planes(cfg, re_grid)
    llr = rate_matching.fused_rate_match_rx_planes(
        g, planes.to(torch.bfloat16), 0, tuple(cfg.cb_e_sizes()), cfg.qm_rate[0],
        p.F).reshape(MAIN_PATH_B * p.C, -1).contiguous()
    return types.SimpleNamespace(cfg=cfg, tb=tb, rx=rx, re_grid=re_grid, graph=g,
                                 planes=planes, llr=llr)


def receiver_host(rcv: types.SimpleNamespace, windows: int) -> dict:
    """Per window, after 3 warm-up batches: one pusch_rx batch's CUDA-event
    ms and host enqueue µs over MAIN_PATH_BATCHES batches, the enqueue µs of one
    call of each kernel wrapper at its own tensors (K3 ``frontend_planes``,
    100 calls; K1 ``decode``, 20 calls), and torch.mul(x, 2)'s on (8, 128).
    -> metric -> samples."""
    cfg, rx = rcv.cfg, rcv.rx
    x = torch.ones((8, 128), device=rx.device)

    def rx_step():
        return pusch.pusch_rx(cfg, rx, n_iters=MAIN_PATH_ITERS)

    for _ in range(3):
        rx_step()
    samples = {"batch_ms": [], "enqueue_us": [], "pusch_frontend_us": [], "layered_f32_us": [],
               "torch_mul_us": []}
    for _ in range(windows):
        samples["batch_ms"].append(events_ms(rx_step, MAIN_PATH_BATCHES))
        samples["enqueue_us"].append(host_us(rx_step, MAIN_PATH_BATCHES))
        samples["pusch_frontend_us"].append(host_us(lambda: fe.frontend_planes(cfg, rcv.re_grid),
                                                    100))
        samples["layered_f32_us"].append(host_us(
            lambda: ldpc_decoder.decode(rcv.graph, rcv.llr, MAIN_PATH_ITERS, check_every=1), 20))
        samples["torch_mul_us"].append(host_us(lambda: torch.mul(x, 2)))
    return samples


def in_torch_mul_calls(samples: dict) -> dict:
    """host metric -> median over the windows of its µs / torch.mul's in the
    same window: the host costs in units that hold across processes."""
    mul = samples["torch_mul_us"]
    return {k: statistics.median(a / m for a, m in zip(v, mul))
            for k, v in samples.items() if k.endswith("_us") and k != "torch_mul_us"}


def run() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_launch measures launches on a GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    samples = turns(probes(dev, gen), WINDOWS)
    rcv = receiver(dev, gen)
    out = pusch.pusch_rx(rcv.cfg, rcv.rx, n_iters=MAIN_PATH_ITERS)
    if not (bool(out["tb_ok"].all()) and torch.equal(out["tb_bits"], rcv.tb)):
        raise AssertionError("main path: a transport block failed")
    host = receiver_host(rcv, WINDOWS)
    result = {"device": torch.cuda.get_device_name(dev), "windows": WINDOWS,
              "probes": summary(samples), "ratio_to_torch_mul": ratios(samples),
              "main_path": {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                            for k, v in host.items()},
              "main_path_in_torch_mul_calls": in_torch_mul_calls(host)}
    print(json.dumps(result))
    return result


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    return run()


if __name__ == "__main__":
    main()
