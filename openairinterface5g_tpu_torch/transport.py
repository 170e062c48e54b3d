"""Transport-block parameters: MCS tables and TBS determination (TS 38.214).

The port's own copy of the part of openairinterface5g_tpu/transport.py it
uses (``mcs_to_qm_rate``, ``compute_tbs`` and the LBRM helpers
``nprb_lbrm``, ``compute_tbs_lbrm``, ``ncb_lbrm``), so that it imports
nothing of the JAX package.  tests/test_torch_pusch.py and
tests/test_torch_coding.py hold them against the originals.
"""
from __future__ import annotations

import math

# TS 38.214 Table 5.1.3.1-1 (qam64): mcs -> (Qm, R*1024)
MCS_TABLE_1 = (
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
    (6, 948),
)

# TS 38.214 Table 5.1.3.1-2 (qam256): mcs -> (Qm, R*1024); fractional R*1024
MCS_TABLE_2 = (
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434),
    (4, 490), (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5),
    (8, 711), (8, 754), (8, 797), (8, 841), (8, 885), (8, 916.5), (8, 948),
)

# TS 38.214 Table 5.1.3.2-1 TBS for Ninfo <= 3824
_TBS_TABLE = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
)


def mcs_to_qm_rate(mcs: int, table: int = 1) -> tuple[int, float]:
    """Returns (Qm, code rate R in [0,1])."""
    tab = MCS_TABLE_1 if table == 1 else MCS_TABLE_2
    qm, r1024 = tab[mcs]
    return qm, r1024 / 1024.0


def compute_tbs(qm: int, r1024: float, n_prb: int, n_symb: int,
                n_dmrs_re_per_prb: int, n_oh: int = 0, n_layers: int = 1) -> int:
    """TBS in bits per TS 38.214 §5.1.3.2."""
    n_re_p = 12 * n_symb - n_dmrs_re_per_prb - n_oh
    n_re = min(156, n_re_p) * n_prb
    ninfo = n_re * (r1024 / 1024.0) * qm * n_layers
    if ninfo <= 3824:
        n = max(3, int(math.floor(math.log2(max(ninfo, 1)))) - 6)
        npinfo = max(24, (int(ninfo) >> n) << n)
        for t in _TBS_TABLE:
            if t >= npinfo:
                return t
        return _TBS_TABLE[-1]
    n = int(math.floor(math.log2(ninfo - 24))) - 5
    npinfo = max(3840, (round((ninfo - 24) / (1 << n))) << n)
    if (r1024 / 1024.0) <= 0.25:
        c = math.ceil((npinfo + 24) / 3816)
        return 8 * c * math.ceil((npinfo + 24) / (8 * c)) - 24
    if npinfo > 8424:
        c = math.ceil((npinfo + 24) / 8424)
        return 8 * c * math.ceil((npinfo + 24) / (8 * c)) - 24
    return 8 * math.ceil((npinfo + 24) / 8) - 24


# TS 38.212 5.4.2.1: the LBRM PRB counts
_NPRB_LBRM = (32, 66, 107, 135, 162, 217, 273)


def nprb_lbrm(n_prb: int) -> int:
    for v in _NPRB_LBRM:
        if n_prb <= v:
            return v
    return _NPRB_LBRM[-1]


def compute_tbs_lbrm(n_prb: int, n_layers: int = 1, table: int = 1) -> int:
    """TBS_LBRM per TS 38.212 5.4.2.1 (nr_compute_tbslbrm analog)."""
    qm = 8 if table == 2 else 6
    return compute_tbs(qm, 948, nprb_lbrm(n_prb), 14, 0, 0, min(n_layers, 4))


def ncb_lbrm(N: int, C: int, n_prb: int, n_layers: int = 1, table: int = 1) -> int:
    """Limited circular buffer size Ncb = min(N, floor(TBS_LBRM/(C*2/3)))."""
    nref = int(math.floor(compute_tbs_lbrm(n_prb, n_layers, table) / (C * (2 / 3))))
    return min(N, nref)
