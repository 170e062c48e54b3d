"""The traced sub-window: spans from the benchmark around the calls into
each layer of the program (each path's ``layer_spans``, built on ``wrap``
and ``patched``), a ``torch.profiler`` trace of CPU and CUDA activity, and
the reduction of that trace to device time and operations per layer, the
device's busy time, its top operations and its idle gaps.

A device operation belongs to the innermost span that was open on the host
when its launch was made (kernels, copies and sets alike, whatever issued
them: PyTorch, cuFFT or the program's own ctypes launches); an operation
launched outside every span belongs to no layer.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120         # of an operation's name in the breakdown
OUTSIDE = "outside every span"


def wrap(fn, span: str):
    """fn, run inside a span of the name `span`."""
    def wrapped(*a, **kw):
        with record_function(span):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def patched(patches: list):
    """Each (module, name, fn) of `patches` put in place while the context
    is held, and the module's own function put back after it (a path's
    ``layer_spans``)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def layer_spans():
    """The uplink receiver's spans (``paths/pusch_rx.py::layer_spans``),
    under the name from before benchmark/paths/, for the port's own tests."""
    from .paths import pusch_rx
    return pusch_rx.layer_spans()


@contextlib.contextmanager
def captured(out: dict):
    """Profile what runs inside, within a WINDOW span; on exit fill `out`
    with ``reduce``'s summary of the trace."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(reduce(events))


def _merge(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(spans: list, t: float):
    """The shortest span (name, start, end) that holds time t, or None."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best


def reduce(events: list) -> dict:
    """Chrome-trace events -> {window_s, busy_s, layer_s {span: device s},
    layer_ops {span: device operations}, device_ops [[name, s]], idle_gaps
    [[what the host was doing, s]]}, over
    the WINDOW span.  An idle gap is named by the span and the operation
    whose launch the device was waiting for."""
    win = next((e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        return {}
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e["name"] != WINDOW]
    ops = [(e["name"], float(e["args"].get("correlation", -1)) if "args" in e else -1,
            float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    ops = [o for o in ops if w0 <= o[2] and o[3] <= w1 + 1e3]
    layer_us, op_us, layer_n = defaultdict(float), defaultdict(float), defaultdict(int)
    launched = []
    for name, corr, a, b in ops:
        name = name[:NAME_CHARS]
        t = launches.get(corr)
        span = _innermost(spans, t) if t is not None else None
        layer = span[0] if span else OUTSIDE
        layer_us[layer] += b - a
        layer_n[layer] += 1
        op_us[name] += b - a
        launched.append((a, b, name, layer))
    busy = _merge([[a, min(b, w1)] for a, b, _, _ in launched])
    gaps = defaultdict(float)
    launched.sort()
    nxt = 0
    for (a, b), (c, _) in zip(busy, busy[1:] + [[w1, w1]]):
        while nxt < len(launched) and launched[nxt][0] < c:
            nxt += 1
        what = launched[nxt][3] + ": " + launched[nxt][2] if nxt < len(launched) else "end"
        gaps[what] += (c - b) * 1e-6
    if busy:
        gaps["before the first operation"] += (busy[0][0] - w0) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "layer_s": {k: v * 1e-6 for k, v in layer_us.items()},
        "layer_ops": dict(layer_n),
        "device_ops": sorted(([k, v * 1e-6] for k, v in op_us.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10],
    }
