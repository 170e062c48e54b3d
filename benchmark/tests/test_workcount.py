"""The work counts frozen in benchmark/workcount.py give, at the main
path's shapes, the operations and bytes of chip_smoke.py's counts
(``_decoder_bound``, ``_k3_ops``), and the roofline divides by the
published peaks only."""
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
    from benchmark.harness import program_config
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


def test_least_time_uses_the_published_peaks():
    assert (workcount.HBM_BYTES_PER_S, workcount.F32_OPS_PER_S) == (3.35e12, 67e12)
    assert workcount.least_s(3.35e12, 1.0) == (1.0, "bytes")
    assert workcount.least_s(1.0, 134e12) == (2.0, "operations")
    assert not hasattr(workcount, "MIN_SUM_OPS_PER_S")
