"""The readers of the program's own spans and counters, each on a
hand-made snapshot of the tracer's ring, and None where the ring is empty
or the program has no tracer."""
import types

import pytest

from benchmark import harness, spec
from openairinterface5g_tpu_torch.utils import profiling
from openairinterface5g_tpu_torch.utils.profiling import Reading, Span

MS = 1_000_000                     # ns

NEW = ("host_self_ms.ofdm", "host_self_ms.frontend", "host_self_ms.coding",
       "host_self_ms.pusch", "retire_wait_ms", "retire_copy_ms", "inflight_calls.mean",
       "k1_iters_per_cb", "retire_held_ms.p95")


def _call(i: int, t: int) -> list:
    """One call's spans from t (in ms), as pusch_rx under the executor opens
    them: 10 ms of dispatch, 9 of pusch_rx, stages of 1-3 ms."""
    def s(name, parent, a, b):
        return Span(name, parent, i, (t + a) * MS, (t + b) * MS)
    return [
        s("phy/ofdm.py", "models/pusch.py", 1, 2),
        s("ops/pusch_frontend.py", "models/pusch.py", 2, 4),
        s("coding/rate_recovery", "models/pusch.py", 4.5, 5),
        s("coding/decode", "models/pusch.py", 5, 8),
        s("coding/desegment", "models/pusch.py", 8, 8.25),
        s("coding/crc", "models/pusch.py", 8.25, 8.5),
        s("models/pusch.py", "runtime/executor.py:dispatch", 0.5, 9.5),
        s("runtime/executor.py:dispatch", None, 0, 10),
        s("runtime/executor.py:wait", None, 20, 23),
        s("runtime/executor.py", None, 23, 24.5),
    ]


SNAP = {
    "spans": _call(0, 0) + _call(1, 100),
    "counts": {
        "coding/decode:iters": [Reading(0, 20.0, 10), Reading(1, 30.0, 10),
                                Reading(1, 5.0, 4)],
        "runtime/executor.py:inflight": [Reading(0, 0.0, 1), Reading(1, 2.0, 1),
                                         Reading(2, 1.0, 1)],
        "runtime/executor.py:held": [Reading(i, 0.001 * (i + 1), 1) for i in range(20)],
    },
    "dropped": 0,
}


def _run():
    return harness.Run(p=None, traffic={"slots_per_call": 32}, setup_s=0.0)


@pytest.fixture
def ring(monkeypatch):
    def use(snap):
        monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return use


def read(name):
    return spec.reader(name)(_run())


def test_host_self_times(ring):
    ring(SNAP)
    assert read("host_self_ms.ofdm") == pytest.approx(1.0)
    assert read("host_self_ms.frontend") == pytest.approx(2.0)
    assert read("host_self_ms.coding") == pytest.approx(0.5 + 3 + 0.25 + 0.25)
    # pusch_rx's 9 ms less its six stages' 7 ms
    assert read("host_self_ms.pusch") == pytest.approx(2.0)
    total = sum(read(f"host_self_ms.{k}") for k in ("ofdm", "frontend", "coding", "pusch"))
    assert total == pytest.approx(9.0)


def test_retire_spans(ring):
    ring(SNAP)
    assert read("retire_wait_ms") == pytest.approx(3.0)
    assert read("retire_copy_ms") == pytest.approx(1.5)


def test_counters(ring):
    ring(SNAP)
    assert read("inflight_calls.mean") == pytest.approx(1.0)
    assert read("retire_held_ms.p95") == pytest.approx(19.05)


def test_k1_iterations_over_several_kept_tensors(ring):
    """Every kept (B*C,) tensor counts: 55 iterations over 24 code blocks;
    the reference's mean over the same pool entries goes to the notes."""
    ring(SNAP)
    run = _run()
    run.traced_calls, run.iters = [0, 1, 0], {0: [1, 1], 1: [4, 2]}
    assert spec.reader("k1_iters_per_cb")(run) == pytest.approx(55 / 24)
    assert "1.6667" in run.notes["k1_iters_per_cb"]
    ring({"spans": [], "counts": {"coding/decode:iters": [Reading(0, 7.0, 7)]},
          "dropped": 0})
    assert read("k1_iters_per_cb") == 1.0


@pytest.mark.parametrize("name", NEW)
def test_empty_ring_reads_none(ring, name):
    ring({"spans": [], "counts": {}, "dropped": 0})
    assert read(name) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_none(monkeypatch, name):
    """The parent commit's program has no snapshot(): every reader gives
    None and raises nothing."""
    bare = types.ModuleType("profiling")
    import openairinterface5g_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", bare)
    monkeypatch.setitem(__import__("sys").modules,
                        "openairinterface5g_tpu_torch.utils.profiling", bare)
    assert read(name) is None


def test_a_span_missing_from_the_stretch_reads_none(ring):
    """A stretch without the wait (the CPU's executor has no event) gives
    no retire_wait_ms rather than 0."""
    ring(dict(SNAP, spans=[s for s in SNAP["spans"] if s.name != "runtime/executor.py:wait"]))
    assert read("retire_wait_ms") is None
    assert read("retire_copy_ms") == pytest.approx(1.5)
