"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 1] [--control-seeds 1,2,3]

For each seed, one run of the cell with a short window (what the program
reads: each number of the check), and for each control seed the control:
the plain reference put in the program's place, its frontend rounded to
bfloat16 at every stage (``nr.bf16``), judged by the same check on the
same sampled calls.  One JSON line per run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def control(cell, seed: int, device) -> dict:
    """The control's numbers for one seed."""
    from benchmark import check, harness, load, nr
    p = nr.Pusch.from_config(cell.config)
    pool, blocks = load.make_pool(p, cell.traffic, seed, device)
    sampled = load.sampled_calls(seed, len(pool), harness.SAMPLED)
    kept, refs = {}, {}
    for k in sampled:
        out = check.reference(p, pool[k % len(pool)], nr.bf16)
        kept[k] = {"llrs": out["llrs"], "tb_bits": out["tb_bits"], "tb_ok": out["tb_ok"],
                   "cb_ok": out["cb_ok"]}
    numbers, _, failed = check.judge(p, sampled, kept, pool, blocks,
                                     [o["tb_ok"] for o in kept.values()],
                                     [o["cb_ok"] for o in kept.values()],
                                     cell.config["check"], refs)
    return {k: v for k, (v, _) in numbers.items()} | {"failed": failed}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    import torch

    from benchmark import harness, spec
    cell = spec.resolve(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        r = harness.run_cell(cell, seed, args.seconds, False, dev, time.perf_counter(), ROOT)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                          "correct": r["correct"],
                          **{k: v["value"] for k, v in r["checks"].items()}}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                          **control(cell, seed, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
