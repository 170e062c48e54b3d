"""The two sweeps that fix a traffic file's numbers, on the card.

    python3 benchmark/tools/sweep.py edge --workload <cell> [--snrs 12,11.5,...] [--seeds 0-11]
    python3 benchmark/tools/sweep.py knee --workload <cell> --periods 1.6,1.4,... [--seconds 6]

``edge``: from the highest SNR down, per SNR every transport block of the
seeds' pools through the program's receiver; the sweep stops at the first
SNR at which one fails.  The edge is then the lowest SNR at which all
decoded, plus 1 dB; at it the plain reference gives the mean iterations a
code block needs.  SNR is per RE and receive antenna of one layer's unit
symbol against the complex noise: noise_std = sqrt(10^(-SNR/10) / 2).

``knee``: the cell's open loop at each period for `seconds`; a period
holds when the generator's lag over the last quarter of the window is no
more than one period above its lag over the first quarter (no growing
backlog).  Prints the closed loop's rate beside it.
"""
import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def noise_std(snr_db: float) -> float:
    return math.sqrt(10 ** (-snr_db / 10) / 2)


def edge(cell, snrs: list, seeds: list, dev) -> None:
    import torch

    from benchmark import check, harness, load, nr
    from openairinterface5g_tpu_torch.models import pusch
    p = nr.Pusch.from_config(cell.config)
    cfg = harness.program_config(cell.config)
    passing = None
    for snr in snrs:
        traffic = dict(cell.traffic, channel=dict(cell.traffic["channel"], noise_std=noise_std(snr)))
        fails = 0
        for seed in seeds:
            pool, blocks = load.make_pool(p, traffic, seed, dev)
            for rx, tb in zip(pool, blocks):
                out = pusch.pusch_rx(cfg, rx, n_iters=cell.config["n_iters"])
                fails += int((~(out["tb_ok"] & (out["tb_bits"] == tb).all(1))).sum())
            if fails:
                break
        print(json.dumps({"snr_db": snr, "noise_std": noise_std(snr), "tb_failed": fails,
                          "seeds": seeds if not fails else seeds[: seeds.index(seed) + 1]}),
              flush=True)
        if fails:
            break
        passing = snr
    if passing is None:
        return
    snr = passing + 1.0
    traffic = dict(cell.traffic, channel=dict(cell.traffic["channel"], noise_std=noise_std(snr)))
    iters, ok = [], 0
    for seed in seeds[:3]:
        pool, blocks = load.make_pool(p, traffic, seed, dev)
        for rx, tb in zip(pool, blocks):
            ref = check.reference(p, rx)
            iters.append(ref["iters"].float().mean().item())
            ok += int((ref["tb_ok"] & (ref["tb_bits"] == tb).all(1)).sum())
        torch.cuda.empty_cache()
    print(json.dumps({"lowest_passing_snr_db": passing, "edge_snr_db": snr,
                      "edge_noise_std": noise_std(snr),
                      "reference_mean_iterations": statistics.mean(iters),
                      "reference_tb_ok": ok, "reference_seeds": seeds[:3]}), flush=True)


def knee(cell, periods: list, seconds: float, dev) -> None:
    from benchmark import harness, load, nr
    from openairinterface5g_tpu_torch.runtime.executor import SlotExecutor
    p = nr.Pusch.from_config(cell.config)
    pool, _ = load.make_pool(p, cell.traffic, 1, dev)
    steps = harness.Steps(harness.program_config(cell.config), cell.config["n_iters"], [])
    ex = SlotExecutor(steps, depth=cell.traffic["depth"], device=dev)
    ex.run([(pool[i % len(pool)],) for i in range(harness.WARM_CALLS)], collect=False)
    ex.stats.clear()
    t0 = time.perf_counter()
    ex.run(load.closed(pool, seconds), collect=False)
    closed = len(ex.stats) / (time.perf_counter() - t0)
    print(json.dumps({"closed_loop_calls_per_s": closed}), flush=True)
    for period_ms in periods:
        ex.stats.clear()
        due, handed = [], []
        ex.run(load.open_loop(pool, seconds, period_ms * 1e-3, due, handed), collect=False)
        lag = [(h - d) * 1e3 for d, h in zip(due, handed)]
        q = max(1, len(lag) // 4)
        lat = [(h + s.complete_us * 1e-6 - d) * 1e3 for d, h, s in zip(due, handed, ex.stats)]
        first, last = statistics.mean(lag[:q]), statistics.mean(lag[-q:])
        print(json.dumps({"period_ms": period_ms, "calls_per_s": 1e3 / period_ms,
                          "lag_first_quarter_ms": first, "lag_last_quarter_ms": last,
                          "holds": last - first <= period_ms,
                          "latency_p50_ms": statistics.median(lat),
                          "latency_p95_ms": sorted(lat)[int(0.95 * (len(lat) - 1))]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("edge", "knee"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--snrs", default=",".join(str(12 - 0.5 * i) for i in range(13)))
    ap.add_argument("--seeds", default=",".join(map(str, range(12))))
    ap.add_argument("--periods", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()
    import torch

    from benchmark import spec
    cell = spec.resolve(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    if args.kind == "edge":
        edge(cell, [float(s) for s in args.snrs.split(",")],
             [int(s) for s in args.seeds.split(",")], dev)
    else:
        knee(cell, [float(s) for s in args.periods.split(",")], args.seconds, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
