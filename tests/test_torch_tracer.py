"""The port's tracer (utils/profiling.py: trace, count, snapshot) and the
spans and counters of the uplink path, on the CPU at a 6-PRB PUSCH: the
off path records nothing and enters no record_function; the on path gives
the stages' names, nesting and calls, K1's iterations as decode_plain
counts them, the executor's in-flight and held counters; span times on
the Chrome trace's clock; and the program's spans under the names of
benchmark/tracing.py::layer_spans.
"""
import json
import types

import numpy as np
import pytest
import torch
import torch.autograd.profiler as torch_autograd_profiler

from benchmark import tracing as bench_tracing
from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import ldpc_decoder
from openairinterface5g_tpu_torch.runtime import executor
from openairinterface5g_tpu_torch.utils import profiling

torch.set_num_threads(1)

DEPTH = 2
CALLS = 3
STAGES = ("phy/ofdm.py", "ops/pusch_frontend.py", "coding/rate_recovery", "coding/decode",
          "coding/desegment", "coding/crc")


@pytest.fixture(scope="module")
def slot():
    """A 6-PRB, 1-layer, 2-RX PUSCH through K3's and K1's plain versions
    (frontend_backend "kernel" on CPU tensors), 2 slots a call, at a noise
    that leaves some code blocks more than one iteration."""
    cfg = pusch.PuschConfig(mu=1, n_prb=6, mcs=9, n_layers=1, n_rx=2, decoder_backend="kernel",
                            frontend_backend="kernel", decoder_check_every=1)
    rng = np.random.default_rng(17)
    tb = torch.as_tensor(rng.integers(0, 2, (2, cfg.tbs)).astype(np.int8))
    tx = pusch.pusch_tx(cfg, tb)[0]
    gen = torch.Generator().manual_seed(17)
    rx = torch.cat([tx, 0.7 * tx], 1)
    re, im = torch.randn((2, *rx.shape), generator=gen)
    return cfg, rx + 0.3 * torch.complex(re, im)


@pytest.fixture
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _run(slot, calls=CALLS):
    cfg, rx = slot
    ex = executor.SlotExecutor(lambda i, x: pusch.pusch_rx(cfg, x, n_iters=8), depth=DEPTH,
                               device="cpu")
    return ex.run([(rx,)] * calls)


def test_the_profiler_flag_the_tracer_reads(clean):
    """active() reads torch.autograd.profiler._is_profiler_enabled, not a
    public API: False outside a capture, True inside torch.profiler.profile
    and profile_to, and enable() turns the tracer on without one."""
    assert torch_autograd_profiler._is_profiler_enabled is False
    assert not profiling.active()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch_autograd_profiler._is_profiler_enabled is True
        assert profiling.active()
    assert not profiling.active()
    profiling.enable()
    assert profiling.active()
    profiling.disable()
    assert not profiling.active()


def test_off_the_path_records_nothing(slot, clean, monkeypatch):
    """Off, no span enters record_function, the ring stays empty and K1 is
    asked for no iterations."""
    entered = []

    class Counting:
        def __init__(self, name, *a):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    kwargs = []

    def decoder(name, _orig=pusch.ldpc_decoder):
        def decode(*a, **kw):
            kwargs.append(kw)
            return _orig(name)(*a, **kw)
        return decode

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch_autograd_profiler, "record_function", Counting)
    monkeypatch.setattr(pusch, "ldpc_decoder", decoder)
    out = _run(slot)
    assert entered == []
    assert profiling.snapshot() == {"spans": [], "counts": {}, "dropped": 0}
    assert len(kwargs) == CALLS and all("return_iters" not in kw for kw in kwargs)
    assert all(bool(o["tb_ok"].all()) for o in out)


def test_on_the_path(slot, clean, monkeypatch):
    """enable(): per call the dispatch span around pusch_rx's span around
    the six stages, then the retire's copy; one call index a call; each
    span's self time plus its children's spans is its own; K1's counter
    is decode_plain's iterations on the same LLRs; nothing in flight on
    the CPU; one held reading a call.  With no capture running, no span
    opens a record_function."""
    llrs, entered = [], []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name, *a: entered.append(name))

    def decoder(name, _orig=pusch.ldpc_decoder):
        def decode(g, llr, **kw):
            llrs.append((g, llr.clone(), kw))
            return _orig(name)(g, llr, **kw)
        return decode

    monkeypatch.setattr(pusch, "ldpc_decoder", decoder)
    profiling.enable()
    out = _run(slot)
    profiling.disable()
    snap = profiling.snapshot()
    assert snap["dropped"] == 0 and entered == []
    spans = snap["spans"]
    assert sorted({s.call for s in spans}) == list(range(CALLS))
    for i in range(CALLS):
        mine = [s for s in spans if s.call == i]
        names = [(s.name, s.parent) for s in mine]
        assert names == ([(n, "models/pusch.py") for n in STAGES]
                         + [("models/pusch.py", "runtime/executor.py:dispatch"),
                            ("runtime/executor.py:dispatch", None),
                            ("runtime/executor.py", None)])
        for s in mine:
            assert s.t0 <= s.t1
            kids = sorted((c for c in mine if c.parent == s.name), key=lambda c: c.t0)
            assert all(s.t0 <= c.t0 and c.t1 <= s.t1 for c in kids)
            assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
            own = (s.t1 - s.t0) - sum(c.t1 - c.t0 for c in kids)
            assert own >= 0 and own + sum(c.t1 - c.t0 for c in kids) == s.t1 - s.t0
    iters = snap["counts"]["coding/decode:iters"]
    assert [r.call for r in iters] == list(range(CALLS)) and len(llrs) == CALLS
    for r, (g, llr, kw) in zip(iters, llrs):
        assert kw["return_iters"] is True
        _, _, want = ldpc_decoder.decode_plain(g, llr, n_iters=8, check_every=1,
                                               return_iters=True)
        assert (r.total, r.n) == (float(want.sum()), want.numel())
    assert sum(r.total for r in iters) > sum(r.n for r in iters)    # some iterate twice
    inflight = snap["counts"]["runtime/executor.py:inflight"]
    assert [(r.call, r.total) for r in inflight] == [(i, 0.0) for i in range(CALLS)]
    held = snap["counts"]["runtime/executor.py:held"]
    assert sorted(r.call for r in held) == list(range(CALLS)) and all(r.total >= 0 for r in held)
    assert all(bool(o["tb_ok"].all()) for o in out)


def test_the_ring_is_bounded(clean, monkeypatch):
    """A full ring refuses records and counts them; reset() empties it."""
    monkeypatch.setattr(profiling, "RING_RECORDS", 3)
    profiling.enable()
    for k in range(5):
        with profiling.trace(f"s{k}"):
            profiling.count("n", k)
    snap = profiling.snapshot()       # a span is kept as it closes, after its count
    assert [s.name for s in snap["spans"]] == ["s0"]
    assert snap["counts"]["n"] == [profiling.Reading(-1, 0.0, 1), profiling.Reading(-1, 1.0, 1)]
    assert snap["dropped"] == 7
    profiling.reset()
    assert profiling.snapshot() == {"spans": [], "counts": {}, "dropped": 0}


# the largest distance allowed between a span's own start and its Chrome
# trace event's.  The clocks are one (Unix time); the gap is the time
# record_function takes to enter before the span stamps its start, about
# 5 us, but up to 5.5 ms for a first span on a loaded CPU (the tier-1 run's
# workers).  Another clock would miss by days.
CLOCK_TOLERANCE_NS = 20_000_000
# the profiler's conversion of its own cycle counter to Unix time, allowed
# either way where one span should lie inside its event
CONVERSION_NS = 200_000


def test_span_times_are_the_chrome_traces(slot, clean, tmp_path):
    """Under profile_to, every span of the ring has its Chrome-trace event
    (ts + baseTimeNanoseconds): the event starts no later than the span and
    within the tolerance before it, and ends no earlier (each up to the
    profiler's clock conversion)."""
    with profiling.profile_to(str(tmp_path)):
        _run(slot, calls=2)
    spans = profiling.snapshot()["spans"]
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events.setdefault(e["name"], []).append(
                (round(float(e["ts"]) * 1e3) + base,
                 round((float(e["ts"]) + float(e["dur"])) * 1e3) + base))
    assert spans
    for name in {s.name for s in spans}:
        mine = sorted((s.t0, s.t1) for s in spans if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        for (t0, t1), (a, b) in zip(mine, theirs):
            assert -CONVERSION_NS <= t0 - a <= CLOCK_TOLERANCE_NS, (name, t0 - a)
            assert t1 <= b + CONVERSION_NS, (name, t1 - b)


def test_program_spans_carry_the_benchmark_wrappers_names(slot, clean, monkeypatch):
    """Each function benchmark/tracing.layer_spans wraps runs inside the
    program's span of the same name or opens it itself, and every wrapper
    fires: a rename or an inlined call fails here instead of dropping a
    span from the benchmark's trace."""
    events = []

    def recorder(kind):
        class Rec:
            def __init__(self, name, *a):
                self.name = name

            def __enter__(self):
                events.append(("enter", kind, self.name))
                return self

            def __exit__(self, *exc):
                events.append(("exit", kind, self.name))
        return Rec

    monkeypatch.setattr(bench_tracing, "record_function", recorder("wrapper"))
    monkeypatch.setattr(torch.profiler, "record_function", recorder("program"))
    # as if a capture ran: the program's spans open their record_function
    monkeypatch.setattr(profiling, "_torch_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=True))
    with bench_tracing.layer_spans():
        _run(slot, calls=2)
    root = {"kind": None, "name": None, "kids": []}
    stack = [root]
    for what, kind, name in events:
        if what == "enter":
            node = {"kind": kind, "name": name, "kids": [], "parent": stack[-1]}
            stack[-1]["kids"].append(node)
            stack.append(node)
        else:
            assert stack.pop()["name"] == name
    fired = set()

    def walk(node):
        for kid in node["kids"]:
            if kid["kind"] == "wrapper":
                fired.add(kid["name"])
                inside = any(k["kind"] == "program" and k["name"] == kid["name"]
                             for k in kid["kids"])
                assert kid["parent"]["name"] == kid["name"] or inside, kid["name"]
            walk(kid)
    walk(root)
    assert fired == {"models/pusch.py", "runtime/executor.py"} | set(STAGES)
