"""The 4-layer uplink path (benchmark/paths/pusch_rx_mimo.py) on the CPU at
a tiny size: the detector's least work against counts by hand at the
configuration and at 2 layers; the pool made from a seed; a whole run of
the cell with the sound program is correct, and with the reference's
bfloat16 frontend in the program's place it is not; its readers give
nothing, and raise nothing, where a run has no trace."""
import dataclasses
import hashlib
import json
import time

import pytest
import torch

from benchmark import harness, nr, spec, workcount
from benchmark.paths import pusch_rx_mimo
from benchmark.spec import HERE

CELL = "nr40-pusch-4l4r-mcs9.clean32"
CONFIG = json.loads((HERE / "configs" / "nr40-pusch-4l4r-mcs9.json").read_text())
SEED = 2**31 + 29
NEW_READERS = ("chest_device_us_per_slot", "equalize_device_us_per_slot", "equalize_roofline_pct",
               "eager_frontend_ops_per_call", "host_self_ms.eager_frontend", "chest_nvar_mean")


@dataclasses.dataclass
class TracedRun:
    p: nr.Pusch
    traced_calls: list
    slots_per_call: int = 32


@pytest.mark.parametrize("conf,per_slot", [
    # 4 layers, 4 RX, 13 data symbols of 1272 subcarriers: y 529152, h 162816,
    # x 529152 and mag 264576 bytes; 8 x (1272 (64 + 128) + 13 x 1272 (16 + 16))
    ("nr40-pusch-4l4r-mcs9", (1485696, 6187008)),
    # 2 layers, 2 RX, 12 data symbols: y 244224, h 40704, x 244224, mag 122112;
    # 8 x (1272 (8 + 16) + 12 x 1272 (4 + 4))
    ("nr40-pusch-2l2r-mcs16", (651264, 1221120)),
])
def test_equalize_work_by_hand(conf, per_slot):
    c = json.loads((HERE / "configs" / f"{conf}.json").read_text())
    run = TracedRun(pusch_rx_mimo.reference_config(c), traced_calls=[3, 4])
    least, by = pusch_rx_mimo.work_of(run, "equalize")
    n_bytes, n_ops = (64 * n for n in per_slot)
    assert (least, by) == (n_bytes / workcount.HBM_BYTES_PER_S, "bytes")
    assert pusch_rx_mimo.equalize_work(64, c["n_layers"], c["n_rx"],
                                       len(run.p.data_symbols), run.p.n_sc) == (n_bytes, n_ops)


def test_pool_of_a_seed():
    """sha256 of a 12-PRB pool (2 calls of 2 slots, clean32's channel): each
    call's samples, then its blocks."""
    p = pusch_rx_mimo.reference_config(dict(CONFIG, n_prb=12))
    traffic = {"slots_per_call": 2, "pool_calls": 2, "channel": {"cross": 0.1, "noise_std": 0.05}}
    pool, blocks = pusch_rx_mimo.make_pool(p, traffic, SEED, torch.device("cpu"))
    h = hashlib.sha256()
    for rx, tb in zip(pool, blocks):
        h.update(rx.numpy().tobytes())
        h.update(tb.numpy().tobytes())
    assert [tuple(rx.shape) for rx in pool] == [(2, 4, 3840)] * 2
    assert h.hexdigest() == "03d5bf8f05ba6b5da5c99900ec9f73c167105e5374c7f965ffed94f714c5ef45"


def tiny_cell():
    cell = spec.resolve(CELL)
    assert cell.path == "pusch_rx_mimo"
    cell.config = dict(cell.config, n_prb=12, n_iters=4)
    cell.traffic = dict(cell.traffic, slots_per_call=2, pool_calls=2)
    return cell


def run(cell):
    return harness.run_cell(cell, SEED, 2.0, False, torch.device("cpu"), time.perf_counter())


def test_sound_program_is_correct():
    r = run(tiny_cell())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"llr_gap", "tb_bits_wrong", "tb_crc_failed", "cb_parity_failed",
                                "cb_flags_differ"}


def test_bf16_frontend_is_not_correct(monkeypatch):
    from openairinterface5g_tpu_torch.models import pusch
    p = pusch_rx_mimo.reference_config(tiny_cell().config)

    def step(cfg, rx, **kw):
        return pusch_rx_mimo.reference(p, rx, nr.bf16)
    monkeypatch.setattr(pusch, "pusch_rx", step)
    r = run(tiny_cell())
    assert not r["correct"], r["checks"]
    assert r["checks"]["llr_gap"]["value"] > 10 * r["checks"]["llr_gap"]["limit"]


def test_layer_spans_put_the_functions_back():
    from openairinterface5g_tpu_torch.coding import rate_matching
    from openairinterface5g_tpu_torch.models import pusch
    names = [(pusch, fn) for fn, _ in pusch_rx_mimo.EAGER_SPANS]
    names += [(pusch, "pusch_rx"), (rate_matching, "fused_rate_match_rx")]
    before = [getattr(m, n) for m, n in names]
    with pusch_rx_mimo.layer_spans():
        assert all(getattr(m, n) is not f for (m, n), f in zip(names, before))
    assert [getattr(m, n) for m, n in names] == before


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_read_nothing_without_a_trace(name):
    empty = harness.Run(p=pusch_rx_mimo.reference_config(CONFIG), traffic={"slots_per_call": 32},
                        setup_s=1.0, path=pusch_rx_mimo)
    assert spec.reader(name)(empty) is None
