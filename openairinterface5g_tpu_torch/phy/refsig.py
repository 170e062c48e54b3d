"""Reference signals: PUSCH/PDSCH DMRS (TS 38.211 §6.4.1.1, §7.4.1.1) of
configuration type 1, single and double symbol; low-PAPR sequences (§5.2.2);
CSI-RS (§7.4.1.5) and PTRS (§6.4.1.2) sequences and positions; PSS and SSS
(§7.4.2.2-3).

Port of openairinterface5g_tpu/phy/refsig.py.  Every sequence here is a
host constant (its cinit is configuration-static); ``dmrs_sequence`` keeps
one per (cinit, length, device) on the device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .scrambling import gold_sequence_np

SQRT_HALF = np.float32(1 / np.sqrt(2))


def dmrs_cinit(slot: int, symbol: int, n_id: int, n_scid: int = 0,
               symbols_per_slot: int = 14) -> int:
    """TS 38.211 §6.4.1.1.1 DMRS scrambling init."""
    return (((1 << 17) * (symbols_per_slot * slot + symbol + 1) * (2 * n_id + 1)
             + 2 * n_id + n_scid) % (1 << 31))


def dmrs_sequence_np(cinit: int, n_pilots: int) -> np.ndarray:
    """r(n) = ((1-2c(2n)) + j(1-2c(2n+1)))/sqrt(2) -> (n_pilots,) complex64."""
    c = gold_sequence_np(int(cinit), 2 * n_pilots).astype(np.float32)
    re = (1.0 - 2.0 * c[0::2]) * SQRT_HALF
    im = (1.0 - 2.0 * c[1::2]) * SQRT_HALF
    return (re + 1j * im).astype(np.complex64)


@functools.lru_cache(maxsize=256)
def dmrs_sequence(cinit: int, n_pilots: int, device: torch.device) -> torch.Tensor:
    """dmrs_sequence_np as a complex64 tensor on `device` (cached)."""
    return torch.as_tensor(dmrs_sequence_np(cinit, n_pilots), device=device)


def pss_sequence(n_id2: int) -> np.ndarray:
    """TS 38.211 §7.4.2.2: the 127-length BPSK m-sequence, float32."""
    x = np.zeros(127, dtype=np.int64)
    x[:7] = [0, 1, 1, 0, 1, 1, 1]
    for i in range(127 - 7):
        x[i + 7] = (x[i + 4] + x[i]) % 2
    m = (np.arange(127) + 43 * n_id2) % 127
    return (1 - 2 * x[m]).astype(np.float32)


def sss_sequence(n_id1: int, n_id2: int) -> np.ndarray:
    """TS 38.211 §7.4.2.3: the 127-length SSS, float32."""
    x0 = np.zeros(127, dtype=np.int64)
    x1 = np.zeros(127, dtype=np.int64)
    x0[0] = 1
    x1[0] = 1
    for i in range(127 - 7):
        x0[i + 7] = (x0[i + 4] + x0[i]) % 2
        x1[i + 7] = (x1[i + 1] + x1[i]) % 2
    m0 = 15 * (n_id1 // 112) + 5 * n_id2
    m1 = n_id1 % 112
    n = np.arange(127)
    return ((1 - 2 * x0[(n + m0) % 127]) * (1 - 2 * x1[(n + m1) % 127])).astype(np.float32)


def dmrs_type1_sc_indices(n_prb: int, delta: int = 0) -> np.ndarray:
    """Occupied DMRS subcarriers within the allocation (comb 2, 6 per PRB)."""
    return (np.arange(6 * n_prb) * 2 + delta).astype(np.int32)


def dmrs_type1_port_weights(port: int) -> tuple[np.ndarray, int]:
    """(wf per pilot pair, delta) for ports 0..3 (TS 38.211 Table 6.4.1.1.3-1):
    ports 0/1 on comb delta 0, ports 2/3 on delta 1; the odd port of each
    CDM group carries the frequency OCC (+1, -1)."""
    delta = 0 if port in (0, 1) else 1
    alt = 1 if port in (0, 2) else -1
    return np.array([1.0, alt], dtype=np.float32), delta


def dmrs_type1_port_weights_double(port: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(wf (2,), wt (2,), delta) for ports 0..7 of double-symbol type 1 DMRS
    (maxLength=2, TS 38.211 Table 6.4.1.1.3-1): ports 0-3 as the single-
    symbol table with wt = (+1, +1); ports 4-7 repeat its frequency pattern
    with the time OCC wt = (+1, -1) across the symbol pair."""
    wf, delta = dmrs_type1_port_weights(port % 4)
    wt = np.array([1.0, 1.0 if port < 4 else -1.0], dtype=np.float32)
    return wf, wt, delta


def _largest_prime_below(n: int) -> int:
    for c in range(n - 1, 1, -1):
        if all(c % k for k in range(2, int(c ** 0.5) + 1)):
            return c
    raise ValueError(n)


def low_papr_sequence(u: int, v: int, length: int) -> np.ndarray:
    """Base sequence r_{u,v}(n) for M >= 36 (TS 38.211 §5.2.2.1): a Zadoff-Chu
    sequence of the largest prime length N_ZC < M, cyclically extended;
    x_q(m) = exp(-j pi q m (m+1) / N_ZC) with q from u and v."""
    n_zc = _largest_prime_below(length)
    qbar = n_zc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
    m = np.arange(n_zc, dtype=np.float64)
    x = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
    return x[np.arange(length) % n_zc].astype(np.complex64)


def csirs_cinit(slot: int, symbol: int, n_id: int, symbols_per_slot: int = 14) -> int:
    """TS 38.211 §7.4.1.5.2 CSI-RS scrambling init."""
    return ((1 << 10) * (symbols_per_slot * slot + symbol + 1) * (2 * n_id + 1)
            + n_id) % (1 << 31)


def csirs_sequence(cinit: int, n_re: int) -> np.ndarray:
    """Gold-seeded QPSK CSI-RS values (the DMRS sequence's mapping)."""
    return dmrs_sequence_np(cinit, n_re)


def ptrs_sc_indices(n_prb: int, k_ptrs: int = 2, re_offset: int = 0) -> np.ndarray:
    """One PTRS subcarrier every K_PTRS PRBs (density-1 frequency pattern)."""
    return (np.arange(0, n_prb, k_ptrs) * 12 + re_offset).astype(np.int32)


# --------------------------------------------------------------------------
# SRS (TS 38.211 §6.4.1.4)
# --------------------------------------------------------------------------

def estimate_common_phase(y: torch.Tensor, h: torch.Tensor, pilots: torch.Tensor) -> torch.Tensor:
    """Per-symbol common phase error from PTRS REs.

    y: (..., n_sym, n_ptrs) received PTRS REs; h: the channel at those REs
    (same shape or broadcastable); pilots: (n_ptrs,) reference values.
    Returns (..., n_sym) unit-magnitude phasors exp(-j phi_hat) to apply to
    the data REs (nr_pusch_ptrs_processing:498 analog).
    """
    z = torch.sum(y * torch.conj(h * pilots), dim=-1)
    return torch.conj_physical(z / torch.clamp(z.abs(), min=1e-12))


def srs_sequence(n_prb: int, comb: int = 2, u: int = 0, v: int = 0,
                 cyclic_shift: int = 0, n_cs_max: int = 8) -> np.ndarray:
    """(m_sc,) SRS sequence, m_sc = 12 n_prb / comb: the low-PAPR base with
    the cyclic shift alpha = 2 pi cyclic_shift / n_cs_max."""
    m_sc = n_prb * 12 // comb
    base = low_papr_sequence(u, v, m_sc)
    alpha = 2 * np.pi * cyclic_shift / n_cs_max
    return (np.exp(1j * alpha * np.arange(m_sc)) * base).astype(np.complex64)


def srs_sc_indices(n_prb: int, comb: int = 2, comb_offset: int = 0) -> np.ndarray:
    """Subcarrier indices of the SRS comb within the sounded PRBs."""
    return (np.arange(n_prb * 12 // comb) * comb + comb_offset).astype(np.int32)


# --------------------------------------------------------------------------
# PRS (TS 38.211 §7.4.1.7)
# --------------------------------------------------------------------------

def prs_cinit(slot: int, symbol: int, n_id_prs: int, symbols_per_slot: int = 14) -> int:
    """TS 38.211 §7.4.1.7.1 sequence init."""
    return (((1 << 22) * (n_id_prs // 1024)
             + (1 << 10) * (symbols_per_slot * slot + symbol + 1) * (2 * (n_id_prs % 1024) + 1)
             + (n_id_prs % 1024)) % (1 << 31))


def prs_sequence(cinit: int, n_re: int) -> np.ndarray:
    """Gold-seeded QPSK PRS values (the DMRS sequence's mapping)."""
    return dmrs_sequence_np(cinit, n_re)


_PRS_STAIRCASE = {
    2: [0, 1],
    4: [0, 2, 1, 3],
    6: [0, 3, 1, 4, 2, 5],
    12: [0, 6, 3, 9, 1, 7, 4, 10, 2, 8, 5, 11],
}


def prs_staircase_offsets(comb_size: int, n_symbols: int, re_offset: int = 0) -> np.ndarray:
    """Per-symbol subcarrier offset of the PRS comb (the staircase of TS 38.211
    Table 7.4.1.7.3-1), comb sizes 2, 4, 6 and 12."""
    pat = _PRS_STAIRCASE[comb_size]
    return np.array([(re_offset + pat[sym % len(pat)]) % comb_size
                     for sym in range(n_symbols)], dtype=np.int32)
