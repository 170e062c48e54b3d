"""One run of one cell: set-up, the measured window, the check, the line.

The window drives the program's slot executor
(``openairinterface5g_tpu_torch.runtime.executor.SlotExecutor.run``), every
step one call of the program path that the cell's configuration names
(``benchmark/paths/<path>.py``: the program call over a call's slots, and
what goes back to the host).  The outputs of a few calls drawn from the
seed stay on the device until the window has closed; the path's check
reads them then.

With ``trace`` the run's window is two stretches: first the untraced one
(host dispatch, latency, lag), then a short one under ``torch.profiler``
with the path's layer spans.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from types import ModuleType

import numpy as np
import torch

from . import load, spec, tracing
from .paths import pusch_rx

SAMPLED = 3              # calls whose outputs the check keeps
WARM_CALLS = 6           # calls before the window, every shape of the cell
TRACED_PASSES = 4        # passes over the pool in the traced stretch
TRACED_SHARE = 0.75      # of the window, the untraced stretch in a traced run
# the uplink receiver's step and configuration under their names from
# before benchmark/paths/, for the port's own tests that drive them
Steps, program_config = pusch_rx.Steps, pusch_rx.program_config


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    p: object                       # the path's reference_config
    traffic: dict
    setup_s: float
    window_s: float = 0.0           # the untraced stretch
    calls: int = 0                  # calls in it
    dispatch_us: list = dataclasses.field(default_factory=list)
    complete_us: list = dataclasses.field(default_factory=list)
    due: list = dataclasses.field(default_factory=list)       # open loop
    handed: list = dataclasses.field(default_factory=list)
    trace: dict | None = None       # tracing.reduce of the traced stretch
    traced_calls: list = dataclasses.field(default_factory=list)   # their pool indices
    iters: dict = dataclasses.field(default_factory=dict)   # pool index -> (C slots,) iterations
    power_limit: str = "not read"
    notes: dict = dataclasses.field(default_factory=dict)
    path: ModuleType | None = None  # the cell's program path

    @property
    def slots_per_call(self) -> int:
        return self.traffic["slots_per_call"]

    @property
    def latency_ms(self) -> list:
        return [(h + c * 1e-6 - d) * 1e3
                for d, h, c in zip(self.due, self.handed, self.complete_us)]


def _window(ex, steps, pool: list, traffic: dict, seconds: float, run: Run) -> None:
    """One stretch of the window on the executor, its stats added to `run`."""
    ex.stats.clear()
    start = steps.n
    due, handed = [], []
    if traffic["loop"] == "open":
        inputs = load.open_loop(pool, seconds, traffic["period_ms"] * 1e-3, due, handed, start)
    else:
        inputs = load.closed(pool, seconds, start)
    t0 = time.perf_counter()
    ex.run(inputs, collect=False)
    run.window_s = time.perf_counter() - t0
    run.calls = len(ex.stats)
    run.dispatch_us = [s.dispatch_us for s in ex.stats]
    run.complete_us = [s.complete_us for s in ex.stats]
    run.due, run.handed = due, handed


def _traced(ex, steps, pool: list, traffic: dict, run: Run) -> None:
    """The traced stretch: TRACED_PASSES passes over the pool, at the
    cell's own pace."""
    n = TRACED_PASSES * len(pool)
    start = steps.n
    if traffic["loop"] == "open":
        period = traffic["period_ms"] * 1e-3
        inputs = load.open_loop(pool, n * period + period / 2, period, [], [], start)
    else:
        inputs = (a for _, a in zip(range(n), load.closed(pool, 1e9, start)))
    out: dict = {}
    with run.path.layer_spans(), tracing.captured(out):
        ex.run(inputs, collect=False)
    run.trace = out
    run.traced_calls = [(start + k) % len(pool) for k in range(steps.n - start)]


def power_limit() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 and got.stdout else "not read"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, root=spec.ROOT) -> dict:
    """The result line of one run (a dict), with "checks" last."""
    from openairinterface5g_tpu_torch.runtime.executor import SlotExecutor

    traffic, path = cell.traffic, spec.path(cell.path, root)
    p = path.reference_config(cell.config)
    cfg = path.program_config(cell.config)
    pool, truth = path.make_pool(p, traffic, seed, device)
    sampled = load.sampled_calls(seed, len(pool), SAMPLED)
    steps = path.steps(cfg, cell.config, sampled)
    ex = SlotExecutor(steps, depth=traffic["depth"], device=device)
    ex.run([(pool[i % len(pool)],) for i in range(WARM_CALLS)], collect=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(p=p, traffic=traffic, setup_s=time.perf_counter() - t_start, path=path)

    steps.counting = True
    _window(ex, steps, pool, traffic, seconds * (TRACED_SHARE if trace else 1.0), run)
    if trace:
        _traced(ex, steps, pool, traffic, run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
        run.power_limit = power_limit()
    else:
        peak, kind = 0, "cpu"

    numbers, attempted, failed = path.verdict(run, steps, pool, truth, sampled,
                                              cell.config["check"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        got = spec.reader(m["name"], root)(run)
        if got is not None:
            metrics[m["name"]] = {"value": got, "unit": m["unit"]}
    result = {"correct": passed(numbers), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    for name, note in run.notes.items():
        print(f"{name}: {note}; {run.power_limit}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    return result


JAX_NAMES = ("jax", "jaxlib", "flax", "openairinterface5g_tpu")


def found_jax() -> list:
    """Loaded modules whose top-level name is one of JAX_NAMES."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(JAX_NAMES))


def passed(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())


def percentile(values: list, q: float) -> float | None:
    return float(np.percentile(values, q)) if values else None
