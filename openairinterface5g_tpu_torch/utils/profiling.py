"""Per-stage timing, the port's tracer, and CUDA profiling (time_meas /
T-tracer analog).

Port of openairinterface5g_tpu/utils/profiling.py onto PyTorch and CUDA.
The reference wraps every PHY stage in rdtsc counters
(common/utils/time_meas.h:96 start_meas/stop_meas, printed by
dump_L1_meas_stats) and streams events to the T tracer shm ring.  Here:

  - Meas/MeasGroup: wall-clock accumulators with the same count/mean/max
    report.  For device work, stop(sync) first waits for the work behind
    `sync`: a CUDA tensor's (or a list, tuple or dict of them) current
    stream, a torch.cuda.Event or a torch.cuda.Stream, so the span covers
    execution, not only the enqueue.
  - the tracer: trace(name) is the program's span and count(name, value)
    its counter.  The tracer is on after enable() until disable(), and
    while a torch.profiler capture runs (profile_to's included); off, a
    span costs one test and records nothing.  On, a span keeps a Span
    record in a bounded ring and, while a capture runs, opens
    torch.profiler.record_function(name), so it lands in the capture;
    snapshot() reads the ring, reset() clears it.  Span times are on the clock of the
    profiler's Chrome trace (Unix time, time.time_ns), so a device trace's
    idle gap can be put down to the host span open across it.
  - profile_to(dir): capture a torch.profiler trace around a code block,
    CPU activity and, where CUDA is available, the card's kernels and
    copies, written as a Chrome trace (TRACE_FILE) into `dir`.

The spans and counters of the uplink path, and what reads them (the
benchmark's per-layer metrics, PERF.md section 3):

  models/pusch.py              pusch_rx                       host_self_ms.pusch
  phy/ofdm.py                  the FFT and the grid's extraction  host_self_ms.ofdm
  ops/pusch_frontend.py        frontend_planes (K3)           host_self_ms.frontend
  coding/rate_recovery, coding/decode, coding/desegment, coding/crc
                                                              host_self_ms.coding
  runtime/executor.py:dispatch step_fn and its event          the call's identity
  runtime/executor.py:wait     the retire's wait for the card retire_wait_ms
  runtime/executor.py          the retire's copy to the host  retire_copy_ms
  counter coding/decode:iters  K1's (B*C,) iterations         k1_iters_per_cb
  counter runtime/executor.py:inflight  earlier calls still on the card at a
                               hand-in                        inflight_calls.mean
  counter runtime/executor.py:held  seconds from a call's dispatch to its
                               retire                         retire_held_ms.p95
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.autograd.profiler as _torch_profiler

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


# ---- the tracer ----

RING_RECORDS = 1 << 16      # records the ring keeps until reset()


class Span(NamedTuple):
    """A closed span: the name of the span open around it in its thread
    (None at the top), the executor's call index (-1 outside a call), start
    and end in ns of Unix time, the clock of the profiler's Chrome trace."""
    name: str
    parent: str | None
    call: int
    t0: int
    t1: int


class Count(NamedTuple):
    """A counter's reading: a number, or a tensor kept by reference (its
    elements are summed by snapshot(), off the traced path)."""
    name: str
    call: int
    value: object


class Reading(NamedTuple):
    """A counter's reading as snapshot() gives it: the sum of its elements
    and their number (1 for a number)."""
    call: int
    total: float
    n: int


class _Tracer:
    """The process's tracer state: the switch, the executor's current call,
    the ring and its dropped-records count, each thread's open spans."""

    def __init__(self):
        self.enabled = False
        self.call = -1
        self.ring: list = []
        self.dropped = 0
        self.local = threading.local()
        self.lock = threading.Lock()

    def keep(self, record) -> None:
        with self.lock:
            if len(self.ring) < RING_RECORDS:
                self.ring.append(record)
            else:
                self.dropped += 1

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


class _Off:
    """The span of an off tracer (a few ns cheaper than nullcontext)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_TRACER = _Tracer()
_OFF = _Off()


def active() -> bool:
    """Whether the tracer records: after enable(), or while a torch.profiler
    capture runs (torch.autograd.profiler's own fast global, set by every
    torch.profiler.profile)."""
    return _TRACER.enabled or _torch_profiler._is_profiler_enabled


def enable() -> None:
    _TRACER.enabled = True


def disable() -> None:
    _TRACER.enabled = False


class _Span:
    __slots__ = ("name", "parent", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # record_function only while a capture consumes it: alone it costs
        # the host tens of us a span and lands nowhere
        self.rf = (torch.profiler.record_function(self.name)
                   if _torch_profiler._is_profiler_enabled else None)
        if self.rf is not None:
            self.rf.__enter__()
        st = _TRACER.stack()
        self.parent = st[-1] if st else None
        st.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _TRACER.stack().pop()
        _TRACER.keep(Span(self.name, self.parent, _TRACER.call, self.t0, t1))
        if self.rf is not None:
            self.rf.__exit__(*exc)


def trace(name: str):
    """The program's span around a block (``with trace(name):``): with the
    tracer on, a Span in the ring and, while a capture runs, a
    record_function span in it; off, nothing."""
    if not (_TRACER.enabled or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Keep a counter's reading for the current call.  Callers test
    active() first, so that an off tracer computes no reading."""
    _TRACER.keep(Count(name, _TRACER.call, value))


def at_call(index: int) -> None:
    """The executor's call that the following spans and readings belong to."""
    _TRACER.call = index


def snapshot() -> dict:
    """The ring: {"spans": [Span], "counts": {name: [Reading]},
    "dropped": records refused by the full ring}.  A tensor reading is
    summed on the host, after its device has finished."""
    spans, counts = [], {}
    with _TRACER.lock:
        ring, dropped = list(_TRACER.ring), _TRACER.dropped
    for r in ring:
        if isinstance(r, Span):
            spans.append(r)
            continue
        v = r.value
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
            total, n = v.to("cpu", torch.float64).sum().item(), v.numel()
        else:
            total, n = float(v), 1
        counts.setdefault(r.name, []).append(Reading(r.call, total, n))
    return {"spans": spans, "counts": counts, "dropped": dropped}


def reset() -> None:
    """Empty the ring, zero its dropped count and the current call."""
    with _TRACER.lock:
        _TRACER.ring.clear()
        _TRACER.dropped = 0
    _TRACER.call = -1


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
