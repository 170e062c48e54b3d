"""The port's 4-layer uplink receiver against the benchmark's plain
reference of it (benchmark/nr_mimo.py), on the CPU at 8 PRB: the port's
pusch_rx on the reference's waveform (4 layers on both CDM groups into 4
antennas, MCS 9, 2 slots) within the configuration's llr_gap, its bits,
CRCs and parity flags exact; the reference's DMRS against the port's and
TS 38.211 Table 6.4.1.1.3-1; the reference's sizes at the configuration
nr40-pusch-4l4r-mcs9; the reference equal to nr.py's at 1 and 2 layers;
the eager frontend's spans and noise counter under the port's tracer.

Budget: about 4 s on one core (the plain decoders dominate).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import nr, nr_mimo
from benchmark.paths import pusch_rx, pusch_rx_mimo
from benchmark.spec import HERE
from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import pusch_frontend
from openairinterface5g_tpu_torch.phy import refsig
from openairinterface5g_tpu_torch.utils import profiling

torch.set_num_threads(1)

CONFIG = json.loads((HERE / "configs" / "nr40-pusch-4l4r-mcs9.json").read_text())
TRAFFIC = {"slots_per_call": 2, "pool_calls": 1, "channel": {"cross": 0.1, "noise_std": 0.05}}
SEED = 2**31 + 23
# TS 38.211 Table 6.4.1.1.3-1, type 1, single symbol: port -> (CDM group's
# comb Delta, w_f(0), w_f(1))
TABLE = {0: (0, 1.0, 1.0), 1: (0, 1.0, -1.0), 2: (1, 1.0, 1.0), 3: (1, 1.0, -1.0)}


@pytest.fixture(scope="module")
def slot():
    """The reference's pool at 8 PRB (4 decoder iterations: one is enough at
    23 dB) and the port's configuration of it."""
    conf = dict(CONFIG, n_prb=8, n_iters=4)
    p = pusch_rx_mimo.reference_config(conf)
    pool, blocks = pusch_rx_mimo.make_pool(p, TRAFFIC, SEED, torch.device("cpu"))
    return conf, p, pusch_rx_mimo.program_config(conf), pool[0], blocks[0]


def test_port_receiver_matches_the_reference(slot):
    conf, p, cfg, rx, tb = slot
    assert cfg.n_layers == 4 and not pusch_frontend.supported(cfg)
    out = pusch.pusch_rx(cfg, rx, n_iters=conf["n_iters"])
    ref = pusch_rx_mimo.reference(p, rx)
    assert pusch_rx.llr_gap(out["llrs"], ref["llrs"]) <= conf["check"]["llr_gap"]
    assert torch.equal(out["tb_bits"], tb) and torch.equal(ref["tb_bits"], tb)
    assert bool(out["tb_ok"].all()) and torch.equal(out["tb_ok"], ref["tb_ok"])
    assert torch.equal(out["cb_ok"], ref["cb_ok"]) and bool(ref["cb_ok"].all())
    numbers, attempted, failed = pusch_rx.judge(p, [0], {0: out}, [rx], [tb], [out["tb_ok"]],
                                                [out["cb_ok"]], conf["check"], {0: ref})
    assert (attempted, failed) == (2, 0)
    assert all(v <= lim for v, lim in numbers.values())


def test_dmrs_of_the_reference_is_the_ports_and_the_table(slot):
    conf, p, cfg, _, _ = slot
    rows = pusch._dmrs_rows(cfg)                       # (L, n_dmrs, M)
    for port, (delta, w0, w1) in TABLE.items():
        assert nr_mimo.port_comb(port) == (delta, w1)
        wf, d = refsig.dmrs_type1_port_weights(port)
        assert (d, float(wf[0]), float(wf[1])) == (delta, w0, w1)
        for si, s in enumerate(p.dmrs_symbols):
            row, pil = nr_mimo.dmrs_row(p, s, port), nr.dmrs_pilots(p, s)
            # subcarrier 4n + 2k' + Delta carries r(2n + k') w_f(k'); the other comb is empty
            assert np.array_equal(row[delta::4], w0 * pil[0::2])
            assert np.array_equal(row[delta + 2::4], w1 * pil[1::2])
            assert not row[1 - delta::2].any()
            np.testing.assert_allclose(row, rows[port, si], rtol=0, atol=1e-7)
    grid = nr_mimo.slot_grid(p, torch.zeros((1, p.G), dtype=torch.int8))
    for s in p.dmrs_symbols:
        for lay in range(p.n_layers):
            assert torch.equal(grid[0, lay, s], torch.as_tensor(nr_mimo.dmrs_row(p, s, lay)))


def test_reference_sizes_at_the_configuration():
    p = pusch_rx_mimo.reference_config(CONFIG)
    assert (p.A, p.seg.bg, p.seg.C, p.seg.Z, p.G, p.samples) == (88064, 1, 11, 384, 132288, 23040)
    assert p.es == [12024] * 8 + [12032] * 3
    assert (p.n_layers, p.n_rx, p.dmrs_symbols, len(p.data_symbols)) == (4, 4, (2,), 13)
    cfg = pusch_rx_mimo.program_config(CONFIG)
    seg, _ = cfg.seg_params()
    assert (cfg.tbs, cfg.G, seg.C, seg.Z, cfg.cb_e_sizes()) == (p.A, p.G, p.seg.C, p.seg.Z, p.es)
    with pytest.raises(ValueError):
        nr.Pusch.from_config(CONFIG)


@pytest.mark.parametrize("name", ["nr100-pusch-1l4r-mcs20", "nr40-pusch-2l2r-mcs16"])
def test_one_and_two_layers_equal_nr(name):
    """At 1 layer nr_mimo's frontend is nr.py's op for op; at 2 the general
    solve stands for nr's closed form, within float32 round-off.  Its
    decoder reads float32 where nr's reads bfloat16: at 23 dB both decode
    every block in one iteration."""
    conf = dict(json.loads((HERE / "configs" / f"{name}.json").read_text()), n_prb=12)
    p = dataclasses.replace(nr.Pusch.from_config(conf), n_iters=2)
    assert nr_mimo.pusch(conf) == dataclasses.replace(p, n_iters=conf["n_iters"])
    tb = torch.randint(0, 2, (2, p.A), generator=torch.Generator().manual_seed(5),
                       dtype=torch.int8)
    assert torch.equal(nr_mimo.transmit(p, tb), nr.transmit(p, tb))
    (rx,), _ = pusch_rx.make_pool(p, TRAFFIC, SEED, torch.device("cpu"))
    want = nr.receive(p, rx)
    got = nr_mimo.receive(p, rx)
    gap = (got["llrs"] - want["llrs"]).abs().max() / want["llrs"].abs().max()
    assert float(gap) <= (0.0 if p.n_layers == 1 else 1e-5)
    assert all(torch.equal(got[k], want[k]) for k in ("tb_bits", "tb_ok", "cb_ok", "iters"))
    assert int(want["iters"].max()) == 1


def test_eager_frontend_spans_and_noise_counter(slot):
    conf, _, cfg, rx, _ = slot
    profiling.reset()
    profiling.enable()
    try:
        pusch.pusch_rx(cfg, rx, n_iters=conf["n_iters"])
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    spans = {s.name: s.parent for s in snap["spans"]}
    for name in ("phy/channel_estimation.py", "phy/equalization.py", "phy/llr.py"):
        assert spans[name] == "models/pusch.py"
    assert "ops/pusch_frontend.py" not in spans
    assert spans["coding/rate_recovery"] == "models/pusch.py"
    (nvar,) = snap["counts"]["phy/channel_estimation:nvar"]
    # noise_std 0.05 per real dimension: 0.005 a complex RE
    assert nvar.n == 2 and abs(nvar.total / nvar.n - 0.005) < 0.001
