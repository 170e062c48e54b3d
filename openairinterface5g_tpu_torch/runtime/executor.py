"""Slot executor: pipelined per-slot dispatch with deadline tracking.

Port of openairinterface5g_tpu/runtime/executor.py, the analog of the
reference's L1 threading (C6): the dedicated L1_rx/L1_tx threads + notified
FIFOs (executables/nr-gnb.c:110-288) and the sl_ahead MAC pipeline become
*dispatch depth*: up to `depth` slots are in flight on the device before
the host blocks on the oldest result.  The executor owns one CUDA stream;
each slot's work is enqueued on it and marked with an event, and retiring
a slot waits on that event, then moves the result to the host.  On the CPU
the work has run by the time step_fn returns, so there is nothing to wait
on.

A host read inside step_fn (``bool(t)``, ``.item()``, ``.cpu()``) waits
for the device there and turns the pipeline into a depth-0 one without
any error; the dispatch times show it (dispatch_us near complete_us), and
with the tracer on (utils/profiling.py) so does its in-flight counter,
which the benchmark reads as ``inflight_calls.mean``: the earlier calls
still running on the card at each hand-in, 0 at depth 0.

Traced, a call's hand-in is the span ``runtime/executor.py:dispatch``; its
retire is ``runtime/executor.py:wait`` (the wait on its event) and then
``runtime/executor.py`` (``to_host``); the counter
``runtime/executor.py:held`` is the seconds from the end of its dispatch to
the start of its retire.

The per-slot timing ring mirrors rt_L1_profiling (nr-gnb.c:162) and
feeds the same style of jitter statistics the reference prints via
time_meas/print_meas.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from ..sim import resolve_device
from ..utils import profiling


@dataclasses.dataclass
class SlotStats:
    slot: int
    dispatch_us: float      # host time to enqueue the slot's work
    complete_us: float      # wall time from dispatch until results ready
    deadline_miss: bool


def to_host(out: Any) -> Any:
    """The result with every tensor moved to the host (lists, tuples and
    dicts walked)."""
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, (list, tuple)):
        return type(out)(to_host(o) for o in out)
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    return out


class SlotExecutor:
    """Run a per-slot function over a stream of inputs, `depth` slots ahead.

    step_fn(slot_idx, *args) enqueues the slot's work and returns tensors
    (or lists, tuples, dicts of them); results are surfaced in order, on
    the host.  device: where step_fn's work runs; the card unless the
    caller asks for the CPU (without CUDA the default raises).
    """

    def __init__(self, step_fn: Callable[..., Any], depth: int = 2,
                 slot_duration_s: float | None = None,
                 device: str | torch.device | None = None):
        self.step_fn = step_fn
        self.depth = depth
        self.slot_duration_s = slot_duration_s
        self.stats: list[SlotStats] = []
        self.device = resolve_device("cuda" if device is None else device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def run(self, inputs: list[tuple], collect: bool = True):
        """Process all slots; returns list of (host) results in order."""
        inflight: collections.deque = collections.deque()
        results = []
        if self.stream is not None:     # the inputs' producers come first
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for i, args in enumerate(inputs):
            if profiling.active():
                profiling.at_call(i)
                profiling.count("runtime/executor.py:inflight",
                                sum(d is not None and not d.query() for *_, d in inflight))
            t0 = time.perf_counter()
            with self._on_stream(), profiling.trace("runtime/executor.py:dispatch"):
                out = self.step_fn(i, *args)
                done = None
                if self.stream is not None:
                    done = torch.cuda.Event()
                    done.record(self.stream)
            t1 = time.perf_counter()
            inflight.append((i, t0, t1, out, done))
            if len(inflight) > self.depth:
                results.append(self._retire(inflight.popleft()))
        while inflight:
            results.append(self._retire(inflight.popleft()))
        return results if collect else None

    def _retire(self, item):
        i, t0, t1, out, done = item
        if profiling.active():
            profiling.at_call(i)
            profiling.count("runtime/executor.py:held", time.perf_counter() - t1)
        if done is not None:
            with profiling.trace("runtime/executor.py:wait"):
                done.synchronize()
        with profiling.trace("runtime/executor.py"):
            out = to_host(out)
        t2 = time.perf_counter()
        miss = (self.slot_duration_s is not None
                and (t2 - t0) > self.slot_duration_s * (self.depth + 1))
        self.stats.append(SlotStats(
            slot=i, dispatch_us=(t1 - t0) * 1e6, complete_us=(t2 - t0) * 1e6,
            deadline_miss=miss))
        return out

    def percentiles(self) -> dict:
        """Latency distribution of retired slots (us)."""
        lat = sorted(s.complete_us for s in self.stats)
        n = len(lat)
        if not n:
            return {}
        return {
            "n_slots": n,
            "mean_us": sum(lat) / n,
            "p50_us": lat[n // 2],
            "p90_us": lat[min(n - 1, int(n * 0.90))],
            "p99_us": lat[min(n - 1, int(n * 0.99))],
            "max_us": lat[-1],
            "deadline_misses": sum(s.deadline_miss for s in self.stats),
        }

    def report(self) -> str:
        """dump_L1_meas_stats-style block (executables/nr-gnb.c:290): the
        per-slot wall-latency distribution against the slot budget."""
        p = self.percentiles()
        if not p:
            return "no slots executed"
        budget = (f"  budget {self.slot_duration_s*1e6:.0f} us x depth "
                  f"{self.depth}" if self.slot_duration_s else "")
        return (f"L1 slot latency (us): mean {p['mean_us']:.0f}  "
                f"p50 {p['p50_us']:.0f}  p90 {p['p90_us']:.0f}  "
                f"p99 {p['p99_us']:.0f}  max {p['max_us']:.0f}  over "
                f"{p['n_slots']} slots{budget}  deadline misses: "
                f"{p['deadline_misses']}")
