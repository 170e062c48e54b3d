"""A whole run on the CPU at a tiny size (the card's look skipped), with the
timed path broken underneath: each fault a receiver can have makes
``correct`` false, and so does the control (the plain reference in the
program's place, its frontend rounded to bfloat16); the sound program
makes it true."""
import time

import pytest
import torch

from benchmark import check, harness, nr, spec

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
                                  "nr100-pusch-1l4r-mcs20.clean32"])
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
    def step(cfg, rx, **kw):                 # half the slots left out
        out = orig(cfg, rx[: rx.shape[0] // 2], **kw)
        return {k: torch.cat([v, v]) if torch.is_tensor(v) else v for k, v in out.items()}
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
        return check.reference(p, rx, nr.bf16)
    return step


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _control])
def test_broken_path_is_not_correct(pusch, monkeypatch, fault):
    monkeypatch.setattr(pusch, "pusch_rx", fault(pusch.pusch_rx))
    r = run(tiny_cell())
    assert not r["correct"], r["checks"]
