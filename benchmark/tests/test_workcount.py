"""The work counts frozen in benchmark/workcount.py give, at the main
path's shapes, the operations and bytes of chip_smoke.py's counts
(``_decoder_bound``, ``_k3_ops``) and, for the LDPC encoder, of a count by
hand; and the roofline divides by the published peaks only."""
import json
import sys

import pytest
import torch

from benchmark import nr, workcount
from benchmark.spec import HERE, ROOT


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def conf(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def capture(chip_smoke, monkeypatch):
    seen = {}
    monkeypatch.setattr(chip_smoke, "_bound",
                        lambda n_bytes, n_ops, ops_per_s=None: seen.update(
                            bytes=n_bytes, ops=n_ops) or (0.0, "x"))
    return seen


@pytest.mark.parametrize("check_every", [0, 1, 2])
def test_decoder_work_equals_chip_smoke(chip_smoke, monkeypatch, check_every):
    from openairinterface5g_tpu_torch.coding import ldpc
    g = ldpc.build_graph(1, 384)
    iters = torch.tensor([1, 2, 3, 8, 5] * 40, dtype=torch.int32)
    x = torch.zeros((len(iters), g.cols * g.Z), dtype=torch.bfloat16)
    seen = capture(chip_smoke, monkeypatch)
    chip_smoke._decoder_bound(g, x, iters, check_every)
    ref = nr.graph(1, 384)
    assert workcount.decoder_work(ref.Z, ref.kc, ref.rows, ref.edges, ref.cols, 2,
                                  iters.tolist(), check_every) == (seen["bytes"], seen["ops"])


@pytest.mark.parametrize("name", ["nr40-pusch-2l2r-mcs16", "nr100-pusch-1l4r-mcs20"])
def test_frontend_ops_equal_chip_smoke(chip_smoke, name):
    from benchmark.paths.pusch_rx import program_config
    c = conf(name)
    cfg = program_config(c)
    chip_smoke.B, saved = 32, chip_smoke.B
    try:
        theirs = chip_smoke._k3_ops(cfg)
    finally:
        chip_smoke.B = saved
    p = nr.Pusch.from_config(c)
    assert workcount.frontend_ops(32, p.n_layers, p.n_rx, p.qm, len(p.dmrs_symbols),
                                  len(p.data_symbols), p.chest_window, p.n_prb) == theirs


# rows of TS 38.212 Table 5.3.2-2 (BG1) and 5.3.2-3 (BG2), their edges
# counted by hand: the 4 core rows, then the extension rows in order
BG1_ROW_EDGES = [19, 19, 19, 19, 3, 8, 9, 7, 10, 9, 7, 8, 7, 6, 7]
BG2_ROW_EDGES = [8, 10, 8, 10, 4, 6, 6, 6, 4, 5, 5, 5, 4, 5, 5, 4, 5]


@pytest.mark.parametrize("bg, Z, E, F, n_cb, hand", [
    # the cell's slot: 7 code blocks, E = 12168, F = 368: 35 columns, 13 rows
    (1, 384, 12168, 368, 7, (7 * (22 + 35) * 384 / 8, 7 * sum(BG1_ROW_EDGES[:13]) * 12)),
    # BG1 at 2 layers of 16QAM: 24 code blocks, E = 13104, F = 56: 37 columns
    (1, 384, 13104, 56, 24, (24 * (22 + 37) * 384 / 8, 24 * sum(BG1_ROW_EDGES) * 12)),
    # BG2 at Z = 64, E = 1600, F = 0: ceil(1728 / 64) = 27 columns, 17 rows
    (2, 64, 1600, 0, 5, (5 * (10 + 27) * 64 / 8, 5 * sum(BG2_ROW_EDGES) * 2)),
])
def test_encoder_work_equals_a_count_by_hand(bg, Z, E, F, n_cb, hand):
    from benchmark.paths import pdsch_tx
    g = nr.graph(bg, Z)
    n_cols = min(g.cols, -(-(E + 2 * Z + F) // Z))
    if bg == 1:
        assert (g.tab[:15] >= 0).sum(1).tolist() == BG1_ROW_EDGES
    got = workcount.encoder_work(Z, g.kc, (g.tab >= 0).sum(1).tolist(), n_cols, n_cb)
    assert got == pytest.approx(hand)
    if n_cb == 7:                  # the path counts the cell's columns from its file
        p = pdsch_tx.reference_config(conf("nr100-pdsch-1l-mcs9"))
        assert (p.seg.C, p.seg.Z, p.seg.F, set(p.es)) == (7, 384, 368, {12168})
        assert n_cols == pdsch_tx.encoder_columns(p) == 35


def test_least_time_uses_the_published_peaks():
    assert (workcount.HBM_BYTES_PER_S, workcount.F32_OPS_PER_S) == (3.35e12, 67e12)
    assert workcount.INT32_OPS_PER_S == pytest.approx(67e12 / 4, rel=0.002)
    assert workcount.least_s(3.35e12, 1.0) == (1.0, "bytes")
    assert workcount.least_s(1.0, 134e12) == (2.0, "operations")
    assert not hasattr(workcount, "MIN_SUM_OPS_PER_S")
