"""The benchmark of the PyTorch and CUDA port (openairinterface5g_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  One run of one cell of BENCHMARK.json:
the cell's configuration and traffic files, the inputs made from the seed
on the card, the cell's shapes warmed up, the window, the check against
the plain reference, and as the last line of standard output one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the checks, each number beside its limit).  Exits
non-zero without a result where CUDA is missing or has fewer cards than
the cell asks for, and where JAX or the JAX package is loaded.

Every cache the run writes lies inside the checkout, at a fixed path: the
port builds its kernels into openairinterface5g_tpu_torch/_build/; Triton
and PyTorch's extension builds (neither used by the port today) are sent
to benchmark/.cache/.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, ROOT)
    loaded = harness.found_jax()
    if loaded:
        print(f"loaded in the measuring process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
