"""LTE reference and synchronization signals (TS 36.211 §6.10-6.11).

Port of openairinterface5g_tpu/lte/refsig.py (lte_dl_cell_spec.c CRS,
lte_gold.c, pss.c / sss.c).  Every sequence is a host constant of its
configuration, numpy, from the Gold generator of phy/scrambling.py.
"""
from __future__ import annotations

import functools

import numpy as np

from ..phy.scrambling import gold_sequence_np

N_RB_MAX = 110
_SQRT2 = np.float32(1.0 / np.sqrt(2.0))


# ---------------------------------------------------------------------------
# CRS (cell-specific reference signals), ports 0/1
# ---------------------------------------------------------------------------

def crs_cinit(ns: int, l: int, cell_id: int, cp: int = 1) -> int:  # noqa: E741
    """TS 36.211 §6.10.1.1 (normal CP: N_CP = 1)."""
    return (1 << 10) * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1) + 2 * cell_id + cp


@functools.lru_cache(maxsize=512)
def crs_sequence_np(ns: int, l: int, cell_id: int, n_rb: int) -> np.ndarray:  # noqa: E741
    """(2 n_rb,) complex64 CRS pilots of slot ns, symbol l: the carrier's part
    of the length-2 N_RB_MAX sequence."""
    c = gold_sequence_np(crs_cinit(ns, l, cell_id), 4 * N_RB_MAX)
    seq = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) * _SQRT2
    return seq[np.arange(2 * n_rb) + (N_RB_MAX - n_rb)].astype(np.complex64)


def crs_symbols(port: int, symbols_per_slot: int = 7) -> tuple:
    """Slot-local OFDM symbols carrying the port's CRS (normal CP)."""
    if port in (0, 1):
        return (0, symbols_per_slot - 3)
    return (1,)                                  # ports 2/3


def crs_v(port: int, l: int, symbols_per_slot: int = 7) -> int:  # noqa: E741
    """Frequency shift v (TS 36.211 §6.10.1.2)."""
    if port == 0:
        return 0 if l == 0 else 3
    if port == 1:
        return 3 if l == 0 else 0
    raise ValueError("CRS ports 0/1 supported")


def crs_sc_indices(n_rb: int, port: int, l: int, cell_id: int) -> np.ndarray:  # noqa: E741
    """(2 n_rb,) subcarriers of the CRS REs in symbol l."""
    return 6 * np.arange(2 * n_rb) + (crs_v(port, l) + cell_id % 6) % 6


# ---------------------------------------------------------------------------
# PSS / SSS
# ---------------------------------------------------------------------------

_PSS_ROOTS = {0: 25, 1: 29, 2: 34}


@functools.lru_cache(maxsize=4)
def pss_sequence_np(nid2: int) -> np.ndarray:
    """(62,) Zadoff-Chu PSS d_u(n) (TS 36.211 §6.11.1.1)."""
    u = _PSS_ROOTS[nid2]
    n = np.arange(62)
    nn = np.where(n < 31, n * (n + 1), (n + 1) * (n + 2))
    return np.exp(-1j * np.pi * u * nn / 63.0).astype(np.complex64)


def _mseq(taps: tuple) -> np.ndarray:
    """(31,) +-1 m-sequence with x(i+5) = sum of x(i+t) for t in taps."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = np.sum(x[i + np.array(taps)]) % 2
    return 1 - 2 * x


@functools.lru_cache(maxsize=512)
def sss_sequence_np(nid1: int, nid2: int, subframe: int) -> np.ndarray:
    """(62,) SSS d(n) of subframe 0 or 5 (TS 36.211 §6.11.2.1)."""
    qp = nid1 // 30
    q = (nid1 + qp * (qp + 1) // 2) // 30
    mp = nid1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    s_t, c_t, z_t = _mseq((0, 2)), _mseq((0, 3)), _mseq((0, 1, 2, 4))
    n = np.arange(31)
    s0, s1 = s_t[(n + m0) % 31], s_t[(n + m1) % 31]
    c0, c1 = c_t[(n + nid2) % 31], c_t[(n + nid2 + 3) % 31]
    z10, z11 = z_t[(n + (m0 % 8)) % 31], z_t[(n + (m1 % 8)) % 31]
    d = np.empty(62, np.float32)
    if subframe == 0:
        d[0::2], d[1::2] = s0 * c0, s1 * c1 * z10
    else:
        d[0::2], d[1::2] = s1 * c0, s0 * c1 * z11
    return d.astype(np.complex64)


def sync_sc_indices(n_sc: int) -> np.ndarray:
    """The central 62 subcarriers (lte/params.py's grid: DC left out, index
    n_sc/2 the first positive-frequency subcarrier)."""
    return n_sc // 2 - 31 + np.arange(62)
