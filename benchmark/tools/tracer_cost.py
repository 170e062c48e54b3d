"""The cost of the program's tracer (openairinterface5g_tpu_torch/utils/
profiling.py) on the card, in one process.

    python3 benchmark/tools/tracer_cost.py [--workload <cell>] [--rounds 4] [--calls 300]

A cell's closed loop on the slot executor, in turns: the tracer off; on
by profiling.enable() (spans and counters kept, no capture); and on under
the benchmark's capture (the --trace 1 stretch: torch.profiler with
benchmark/tracing.py's layer spans, a pass over the pool's calls 4
times).  The turns go off, on, capture, capture, on, off, each round.  A
line a turn: wall and executor dispatch ms a call, and where the tracer
was on the spans' ms a call (dispatch, pusch_rx, the four host self times).
Then a summary: each mode's medians against the off turns' and the off
path's own cost a call, the ns of one off span or test on this host times
the spans and tests a call passes; and the ns of one span on, and of the
record_function it opens, alone.
"""
import argparse
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

ACTIVE_TESTS = 3          # active() tests a call: the hand-in, the retire, the decode


def _turn(ex, pool, calls, mode, profiling, tracing) -> dict:
    from benchmark import load, spans
    profiling.reset()
    ex.stats.clear()
    inputs = (a for _, a in zip(range(calls), load.closed(pool, 1e9)))
    out: dict = {}

    def go() -> float:
        t0 = time.perf_counter()
        ex.run(inputs, collect=False)
        return time.perf_counter() - t0

    if mode == "enable":
        profiling.enable()
        try:
            wall = go()
        finally:
            profiling.disable()
    elif mode == "capture":          # the trace's export and reduction are not timed
        with tracing.layer_spans(), tracing.captured(out):
            wall = go()
    else:
        wall = go()
    got = {"mode": mode, "calls": len(ex.stats), "wall_ms_a_call": wall / len(ex.stats) * 1e3,
           "dispatch_ms_a_call": statistics.mean(s.dispatch_us for s in ex.stats) * 1e-3}
    if mode != "off":
        snap = profiling.snapshot()
        got["spans_a_call"] = len(snap["spans"]) / len(ex.stats)
        got["dispatch_span_ms"] = spans.span_ms(spans.DISPATCH)
        got["pusch_span_ms"] = spans.span_ms("models/pusch.py")
        for key, names in (("ofdm", ("phy/ofdm.py",)), ("frontend", ("ops/pusch_frontend.py",)),
                           ("coding", ("coding/rate_recovery", "coding/decode",
                                       "coding/desegment", "coding/crc")),
                           ("pusch", ("models/pusch.py",))):
            got[f"host_self_ms.{key}"] = spans.self_ms(names)
        got["retire_wait_ms"] = spans.span_ms("runtime/executor.py:wait")
        got["retire_copy_ms"] = spans.span_ms("runtime/executor.py")
        got["inflight_calls.mean"] = spans.mean("runtime/executor.py:inflight")
    profiling.reset()
    return got


def span_ns(profiling) -> dict:
    """ns of one span and one active() test with the tracer off; of one
    span with the tracer on by enable() and of the record_function it
    opens, alone, with no capture running."""
    import torch

    def span():
        with profiling.trace("x"):
            pass

    def record():
        with torch.profiler.record_function("x"):
            pass

    def ns(fn, n):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9

    got = {"off_span_ns": ns(span, 200_000), "active_ns": ns(profiling.active, 200_000),
           "record_function_ns": ns(record, 20_000)}
    profiling.enable()
    try:
        got["on_span_ns"] = ns(span, 2_000)
    finally:
        profiling.disable()
        profiling.reset()
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="nr40-pusch-2l2r-mcs16.clean32")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    args = ap.parse_args()
    import torch

    from benchmark import harness, load, nr, spec, tracing
    from openairinterface5g_tpu_torch.runtime.executor import SlotExecutor
    from openairinterface5g_tpu_torch.utils import profiling
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    cell = spec.resolve(args.workload, ROOT)
    p = nr.Pusch.from_config(cell.config)
    pool, _ = load.make_pool(p, cell.traffic, args.seed, dev)
    steps = harness.Steps(harness.program_config(cell.config), cell.config["n_iters"], [])
    ex = SlotExecutor(steps, depth=cell.traffic["depth"], device=dev)
    ex.run([(pool[i % len(pool)],) for i in range(harness.WARM_CALLS)], collect=False)
    captured_calls = harness.TRACED_PASSES * len(pool)
    rows = []
    for _ in range(args.rounds):
        for mode in ("off", "enable", "capture", "capture", "enable", "off"):
            rows.append(_turn(ex, pool, captured_calls if mode == "capture" else args.calls,
                              mode, profiling, tracing))
            print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "card": harness.power_limit(), **span_ns(profiling)}
    base = {k: statistics.median(r[k] for r in rows if r["mode"] == "off")
            for k in ("wall_ms_a_call", "dispatch_ms_a_call")}
    summary["off"] = base
    for mode in ("enable", "capture"):
        mine = [r for r in rows if r["mode"] == mode]
        med = {k: statistics.median(r[k] for r in mine) for k in mine[0] if k != "mode"}
        med["wall_ms_a_call_over_off"] = med["wall_ms_a_call"] - base["wall_ms_a_call"]
        med["dispatch_ms_a_call_over_off"] = med["dispatch_ms_a_call"] - base["dispatch_ms_a_call"]
        summary[mode] = med
    spans_a_call = summary["enable"]["spans_a_call"]
    summary["off_path_us_a_call"] = (spans_a_call * summary["off_span_ns"]
                                     + ACTIVE_TESTS * summary["active_ns"]) * 1e-3
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
