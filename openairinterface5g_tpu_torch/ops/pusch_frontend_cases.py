"""K3's cases: the configurations and batch sizes at which the fused
frontend (``ops/pusch_frontend.py``, ``csrc/pusch_frontend.cu``) is held
against its plain version, shared by the CPU model of its schedule
(tests/test_torch_frontend_tiles.py), its card tests
(tests/test_torch_cuda.py) and ``chip_smoke.py``.  Keyword arguments of
``PuschConfig(mu=1, **kw)``."""

# The edges of K3's tiles (one cluster per slot, one tile per block, the
# estimate over the tile plus a halo): the main path's configuration, a BWP
# offset, tiny allocations whose tiles hold fewer pilots than the halo,
# windows 0, 1 and 16 (wider than a tile), delta 1 at full width, 4 RX and
# 2 DMRS symbols.
EDGE_CFGS = [
    dict(n_prb=273, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=24, n_bwp_prb=40, prb_start=7, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=1, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=3, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=1, mcs=9, n_layers=1, n_rx=2),
    dict(n_prb=24, mcs=16, n_layers=2, n_rx=2, chest_window=0),
    dict(n_prb=24, mcs=16, n_layers=2, n_rx=2, chest_window=1),
    dict(n_prb=24, mcs=16, n_layers=2, n_rx=2, chest_window=16),
    dict(n_prb=3, mcs=16, n_layers=2, n_rx=2, chest_window=16),
    dict(n_prb=273, mcs=16, n_layers=2, n_rx=2, dmrs_port0=2),
    dict(n_prb=51, mcs=19, n_layers=2, n_rx=4),
    dict(n_prb=51, mcs=16, n_layers=2, n_rx=2, dmrs_symbols=(2, 11)),
]

# Many antennas at full width: shared memory holds one group of antennas at
# a time, so these take more than one group (and several rounds of staged
# data symbols per group).
WIDE_CFGS = [
    dict(n_prb=273, mcs=16, n_layers=2, n_rx=16, dmrs_symbols=(2, 5, 8, 11)),
    dict(n_prb=273, mcs=16, n_layers=1, n_rx=32),
    dict(n_prb=273, mcs=16, n_layers=1, n_rx=16),
]

# (configuration, slots) of the card's cases: every edge at B = 3, the main
# path's configuration at B = 1 and B = 40 (more clusters than the card
# holds at once), and the wide ones at B = 2
CARD_CASES = ([(kw, 3) for kw in EDGE_CFGS]
              + [(EDGE_CFGS[0], 1), (EDGE_CFGS[0], 40)]
              + [(kw, 2) for kw in WIDE_CFGS])
