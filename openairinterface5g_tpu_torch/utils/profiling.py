"""Per-stage timing + CUDA profiling (time_meas / T-tracer analog).

Port of openairinterface5g_tpu/utils/profiling.py onto PyTorch and CUDA.
The reference wraps every PHY stage in rdtsc counters
(common/utils/time_meas.h:96 start_meas/stop_meas, printed by
dump_L1_meas_stats) and streams events to the T tracer shm ring.  Here:

  - Meas/MeasGroup: wall-clock accumulators with the same count/mean/max
    report.  For device work, stop(sync) first waits for the work behind
    `sync`: a CUDA tensor's (or a list, tuple or dict of them) current
    stream, a torch.cuda.Event or a torch.cuda.Stream, so the span covers
    execution, not only the enqueue.
  - trace(name): a torch.profiler.record_function span, so stages show up
    named in captured traces (T-tracer analog).
  - profile_to(dir): capture a torch.profiler trace around a code block,
    CPU activity and, where CUDA is available, the card's kernels and
    copies, written as a Chrome trace (TRACE_FILE) into `dir`.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"


def _wait(sync) -> None:
    """Block until the device work behind `sync` has run: a CUDA tensor's
    current stream, an event's or a stream's own work (anything with a
    synchronize method), each leaf of a list, tuple or dict."""
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.current_stream(sync.device).synchronize()
    elif isinstance(sync, dict):
        for v in sync.values():
            _wait(v)
    elif isinstance(sync, (list, tuple)):
        for v in sync:
            _wait(v)
    elif hasattr(sync, "synchronize"):
        sync.synchronize()


@dataclass
class Meas:
    name: str
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None):
        if sync is not None:
            _wait(sync)
        dt = time.perf_counter() - self._t0
        self.count += 1
        self.total += dt
        self.max = max(self.max, dt)
        return dt

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MeasGroup:
    """Named stage timers; print_meas-style report."""

    def __init__(self):
        self._meas: dict[str, Meas] = {}

    def __getitem__(self, name: str) -> Meas:
        if name not in self._meas:
            self._meas[name] = Meas(name)
        return self._meas[name]

    @contextlib.contextmanager
    def measure(self, name: str, sync_result=None):
        m = self[name]
        m.start()
        box = {}
        try:
            yield box
        finally:
            m.stop(box.get("sync", sync_result))

    def report(self) -> str:
        lines = [f"{'stage':<32}{'count':>8}{'mean us':>12}{'max us':>12}{'total ms':>12}"]
        for m in sorted(self._meas.values(), key=lambda x: -x.total):
            lines.append(
                f"{m.name:<32}{m.count:>8}{m.mean*1e6:>12.1f}{m.max*1e6:>12.1f}{m.total*1e3:>12.2f}")
        return "\n".join(lines)


def trace(name: str):
    """Named span in captured traces (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a trace of the block (CPU activity, and the card's when CUDA
    is available) and write it as a Chrome trace, log_dir/TRACE_FILE (open
    with Perfetto or chrome://tracing).  Yields the torch.profiler.profile,
    whose rows can be read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
