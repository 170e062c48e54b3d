"""A whole run on the CPU at a tiny size (the card's look skipped), with the
timed path broken underneath: each fault a receiver or a transmitter can
have makes ``correct`` false, and so does each path's control (the plain
reference in the program's place, rounded to bfloat16: the receiver's
frontend, the transmitter's RE grid); the sound program makes it true."""
import time

import pytest
import torch

from benchmark import harness, nr, spec
from benchmark.paths import pdsch_tx, pusch_rx

SEED = 2**31 + 11


def tiny_cell(name="nr40-pusch-2l2r-mcs16.clean32"):
    cell = spec.resolve(name)
    cell.config = dict(cell.config, n_prb=12)
    cell.traffic = dict(cell.traffic, slots_per_call=2, pool_calls=2, period_ms=100.0)
    return cell


def run(cell):
    return harness.run_cell(cell, SEED, 2.0, False, torch.device("cpu"), time.perf_counter())


@pytest.fixture
def pusch():
    from openairinterface5g_tpu_torch.models import pusch
    return pusch


@pytest.mark.parametrize("name", ["nr40-pusch-2l2r-mcs16.clean32", "nr40-pusch-2l2r-mcs16.open32",
                                  "nr100-pusch-1l4r-mcs20.clean32", "nr100-pdsch-1l-mcs9.tx32"])
def test_sound_program_is_correct(name):
    r = run(tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


def _stale(orig):
    first = {}

    def step(cfg, rx, **kw):                 # the state never moves on
        if "out" not in first:
            first["out"] = orig(cfg, rx, **kw)
        return first["out"]
    return step


def _half(orig):
    def twice(v):
        return torch.cat([v, v]) if torch.is_tensor(v) else v

    def step(cfg, x, **kw):                  # half the slots left out
        out = orig(cfg, x[: x.shape[0] // 2], **kw)
        if isinstance(out, dict):
            return {k: twice(v) for k, v in out.items()}
        return tuple(twice(v) for v in out)
    return step


def _altered(orig):
    def step(cfg, rx, **kw):                 # one decoded bit changed where it is made
        out = dict(orig(cfg, rx, **kw))
        out["tb_bits"] = out["tb_bits"].clone()
        out["tb_bits"][0, 7] ^= 1
        return out
    return step


def _control(_orig):
    p = nr.Pusch.from_config(tiny_cell().config)

    def step(cfg, rx, **kw):
        return pusch_rx.reference(p, rx, nr.bf16)
    return step


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _control])
def test_broken_path_is_not_correct(pusch, monkeypatch, fault):
    monkeypatch.setattr(pusch, "pusch_rx", fault(pusch.pusch_rx))
    r = run(tiny_cell())
    assert not r["correct"], r["checks"]


TX_CELL = "nr100-pdsch-1l-mcs9.tx32"


def _flipped(orig):
    def step(cfg, tb, **kw):                 # one bit of the block changed before it is coded
        tb = tb.clone()
        tb[0, 7] ^= 1
        return orig(cfg, tb, **kw)
    return step


def _tx_control(_orig):
    p = pdsch_tx.reference_config(tiny_cell(TX_CELL).config)

    def step(cfg, tb, **kw):
        ref = pdsch_tx.reference(p, tb, nr.bf16)
        return ref["waveform"], ref["cw_bits"]
    return step


@pytest.mark.parametrize("fault", [_stale, _half, _flipped, _tx_control])
def test_broken_tx_path_is_not_correct(monkeypatch, fault):
    from openairinterface5g_tpu_torch.models import pdsch
    monkeypatch.setattr(pdsch, "pdsch_tx", fault(pdsch.pdsch_tx))
    r = run(tiny_cell(TX_CELL))
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
