"""The plain reference on the CPU at a tiny size: its transmitter through
its receiver recovers every transport block; its codewords satisfy every
parity check; its decoder stops where the parity holds; its LDPC tables
hold the entries of TS 38.212 written out below."""
import json

import pytest
import torch

from benchmark import check, load, nr
from benchmark.spec import HERE


def tiny(name: str, **over) -> nr.Pusch:
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return nr.Pusch.from_config(dict(conf, n_prb=12, **over))


TRAFFIC = {"slots_per_call": 2, "pool_calls": 1, "channel": {"cross": 0.1, "noise_std": 0.05}}


@pytest.mark.parametrize("name", ["nr40-pusch-2l2r-mcs16", "nr100-pusch-1l4r-mcs20"])
def test_transmitter_through_receiver_recovers_every_block(name):
    p = tiny(name)
    pool, blocks = load.make_pool(p, TRAFFIC, 2**31 + 5, torch.device("cpu"))
    ref = check.reference(p, pool[0])
    assert bool(ref["tb_ok"].all()) and bool(ref["cb_ok"].all())
    assert torch.equal(ref["tb_bits"], blocks[0])
    assert int(ref["iters"].max()) == 1          # 23 dB: one iteration


def test_codewords_satisfy_every_parity_check():
    g = nr.graph(1, 64)
    info = torch.randint(0, 2, (4, g.kc * g.Z), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(3))
    cw = nr.ldpc_encode(g, info)
    assert bool(nr.syndrome_ok(g, cw).all())
    assert torch.equal(cw[:, : g.kc * g.Z], info)
    cw[0, 5] ^= 1
    assert nr.syndrome_ok(g, cw).tolist() == [False, True, True, True]


def test_decoder_stops_once_parity_holds():
    g = nr.graph(1, 64)
    info = torch.randint(0, 2, (2, g.kc * g.Z), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(4))
    llr = 4.0 * (1 - 2 * nr.ldpc_encode(g, info).float())
    llr[:, : 2 * g.Z] = 0                        # the punctured head
    bits, ok, iters = nr.decode(g, llr, n_iters=8, check_every=1)
    assert torch.equal(bits, info) and bool(ok.all()) and iters.tolist() == [1, 1]


def test_sizes_of_the_two_configurations():
    p = nr.Pusch.from_config(json.loads((HERE / "configs" / "nr40-pusch-2l2r-mcs16.json").read_text()))
    assert (p.fft, p.samples, p.data_symbols[:3], len(p.data_symbols)) == (1536, 23040, [0, 1, 3], 12)
    assert (p.A, p.G, p.seg.bg, p.seg.C, p.seg.Z) == (77896, 122112, 1, 10, 384)
    q = nr.Pusch.from_config(json.loads((HERE / "configs" / "nr100-pusch-1l4r-mcs20.json").read_text()))
    assert (q.fft, q.samples, q.dmrs_symbols) == (4096, 61440, (2, 11))
    assert (q.A, q.G, q.qm, q.seg.C, q.seg.Z) == (131176, 235872, 6, 16, 384)


def test_gold_sequence_of_a_known_cinit():
    # TS 38.211 5.2.1 with cinit 0: x2 is all zero, so c is x1 from n = 1600
    x1 = [1] + [0] * 30
    for n in range(1600 + 40):
        x1.append(x1[n + 3] ^ x1[n])
    assert nr.gold(0, 40).tolist() == x1[1600:1640]


# TS 38.212 Table 5.3.2-2 (BG1) and 5.3.2-3 (BG2), written out from the
# specification: (column, V) of a row at set iLS
BG1_ROW0_SET0 = [(0, 250), (1, 69), (2, 226), (3, 159), (5, 100), (6, 10), (9, 59), (10, 229),
                 (11, 110), (12, 191), (13, 9), (15, 195), (16, 23), (18, 190), (19, 35),
                 (20, 239), (21, 31), (22, 1), (23, 0)]
BG1_ROW0_SET1 = [307, 19, 50, 369, 181, 216, 317, 288, 109, 17, 357, 215, 106, 242, 180, 330,
                 346, 1, 0]
BG1_ROW1_SET0 = [(0, 2), (2, 239), (3, 117), (4, 124), (5, 71), (7, 222), (8, 104), (9, 173),
                 (11, 220), (12, 102), (14, 109), (15, 132), (16, 142), (17, 155), (19, 255),
                 (21, 28), (22, 0), (23, 0), (24, 0)]
BG2_ROW0_SET0 = [(0, 9), (1, 117), (2, 204), (3, 26), (6, 189), (9, 205), (10, 0), (11, 0)]
BG2_ROW1_SET0 = [(0, 167), (3, 166), (4, 253), (5, 125), (6, 226), (7, 156), (8, 224),
                 (9, 252), (11, 0), (12, 0)]


def _row(tab, row):
    return [(int(j), int(tab[row, j])) for j in (tab[row] >= 0).nonzero()[0]]


def test_ldpc_tables_hold_the_specification():
    import numpy as np
    t = np.load(nr._TABLES)
    bg1, bg2 = t["bg1"], t["bg2"]
    assert bg1.shape == (8, 46, 68) and bg2.shape == (8, 42, 52)
    # one edge set for every iLS: 316 edges in BG1, 197 in BG2
    assert all(np.array_equal(b[i] >= 0, b[0] >= 0) for b in (bg1, bg2) for i in range(8))
    assert int((bg1[0] >= 0).sum()) == 316 and int((bg2[0] >= 0).sum()) == 197
    assert _row(bg1[0], 0) == BG1_ROW0_SET0 and _row(bg1[0], 1) == BG1_ROW1_SET0
    assert [v for _, v in _row(bg1[1], 0)] == BG1_ROW0_SET1
    assert _row(bg2[0], 0) == BG2_ROW0_SET0 and _row(bg2[0], 1) == BG2_ROW1_SET0
    # BG1 row 4: columns 0, 1 and its own parity column 26
    assert [j for j, _ in _row(bg1[0], 4)] == [0, 1, 26]
    # the extension: row r >= 4 holds parity column kc + r alone, unshifted
    for b, kc in ((bg1, 22), (bg2, 10)):
        for r in range(4, b.shape[1]):
            col = b[:, :, kc + r]
            assert (col[:, r] == 0).all() and int((col[0] >= 0).sum()) == 1
    # the double-diagonal core column: (1, 0, -, 1), but (0, 105, -, 0) at
    # BG1 iLS 6; BG2 (0, -, 1, 0), but (1, -, 0, 1) at iLS 3 and 7
    assert [bg1[i, :4, 22].tolist() for i in range(8)] == (
        [[1, 0, -1, 1]] * 6 + [[0, 105, -1, 0], [1, 0, -1, 1]])
    assert [bg2[i, :4, 10].tolist() for i in (0, 3, 7)] == (
        [[0, -1, 1, 0], [1, -1, 0, 1], [1, -1, 0, 1]])
