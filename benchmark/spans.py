"""What the program's own tracer kept (openairinterface5g_tpu_torch/
utils/profiling.py: spans and counters inside pusch_rx and the slot
executor).  The tracer is on only while a torch.profiler capture runs, so
its ring holds the traced stretch and nothing else.  A program without the
tracer, or a ring left empty, gives None.
"""
from __future__ import annotations

DISPATCH = "runtime/executor.py:dispatch"   # one span a call handed in


def snapshot() -> dict | None:
    from openairinterface5g_tpu_torch.utils import profiling
    read = getattr(profiling, "snapshot", None)
    got = read() if read is not None else None
    return got if got and (got["spans"] or got["counts"]) else None


def _calls(snap: dict) -> int:
    return sum(s.name == DISPATCH for s in snap["spans"])


def self_ms(names: tuple) -> float | None:
    """Host self time a call of the spans named `names`: their durations
    less those of the spans opened directly inside them, over the calls the
    stretch handed in."""
    snap = snapshot()
    n = _calls(snap) if snap else 0
    spans = snap["spans"] if n else []
    if not any(s.name in names for s in spans):
        return None
    own = sum(s.t1 - s.t0 for s in spans if s.name in names)
    inner = sum(s.t1 - s.t0 for s in spans if s.parent in names)
    return (own - inner) / n * 1e-6


def span_ms(name: str) -> float | None:
    """Host time a call inside the spans named `name`."""
    snap = snapshot()
    n = _calls(snap) if snap else 0
    spans = [s for s in snap["spans"] if s.name == name] if n else []
    return sum(s.t1 - s.t0 for s in spans) / n * 1e-6 if spans else None


def readings(name: str) -> list:
    """The counter's readings (call, total, n), empty where it has none."""
    snap = snapshot()
    return snap["counts"].get(name, []) if snap else []


def mean(name: str) -> float | None:
    """A counter's mean over its elements: summed totals over their count."""
    got = readings(name)
    n = sum(r.n for r in got)
    return sum(r.total for r in got) / n if n else None
