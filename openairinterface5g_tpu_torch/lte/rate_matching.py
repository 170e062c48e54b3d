"""LTE rate matching (TS 36.212 §5.1.4), turbo and convolutional.

Port of openairinterface5g_tpu/lte/rate_matching.py (lte_rate_matching.c):
the sub-block interleaver, circular buffer and NULL skipping collapse into
one host gather index per (K, E, rv, Ncb, F), cached; TX is one gather, RX
one scatter-add (index_add_: repeated positions sum, in an order that may
differ from XLA's, so the RX holds to a tolerance, not to bits).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# column permutation patterns (TS 36.212 Table 5.1.4-1 / 5.1.4-2)
_P_TURBO = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22,
                     14, 30, 1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27,
                     7, 23, 15, 31], np.int64)
_P_CONV = np.array([1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23,
                    15, 31, 0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26,
                    6, 22, 14, 30], np.int64)


def _subblock(D: int, perm: np.ndarray, plus_one: bool = False) -> np.ndarray:
    """(Kpi,) indices into the stream (-1 = NULL pad): ND nulls prepended, an
    R x 32 matrix filled by rows, columns permuted, read by columns;
    plus_one is the turbo d2 variant pi(k) = (P[k/R] + 32 (k%R) + 1) mod Kpi."""
    C = 32
    R = -(-D // C)
    Kpi = R * C
    y = np.concatenate([np.full(Kpi - D, -1, np.int64), np.arange(D)])
    if plus_one:
        k = np.arange(Kpi)
        return y[(perm[k // R] + C * (k % R) + 1) % Kpi]
    return y[C * np.arange(R)[None, :] + perm[:, None]].reshape(-1)


@functools.lru_cache(maxsize=256)
def turbo_rm_indices(K: int, E: int, rv: int, ncb: int | None = None, F: int = 0) -> np.ndarray:
    """(E,) gather indices into flat d = concat(d0, d1, d2), D = K + 4:
    circular-buffer bit selection with NULL skipping; the filler positions
    (the first F of d0 and of d1, TS 36.212 §5.1.3.2.2) count as NULL."""
    D = K + 4
    v0 = _subblock(D, _P_TURBO)
    v1 = _subblock(D, _P_TURBO)
    v2 = _subblock(D, _P_TURBO, plus_one=True)
    Kpi = len(v0)
    w = np.empty(3 * Kpi, np.int64)            # circular-buffer position -> flat d
    w[:Kpi] = np.where(v0 >= 0, v0, -1)
    w[Kpi::2] = np.where(v1 >= 0, v1 + D, -1)
    w[Kpi + 1:: 2] = np.where(v2 >= 0, v2 + 2 * D, -1)
    if F:
        filler = np.zeros(3 * D + 1, bool)
        filler[:F] = True
        filler[D: D + F] = True
        w = np.where((w >= 0) & filler[np.maximum(w, 0)], -1, w)
    Ncb = 3 * Kpi if ncb is None else min(ncb, 3 * Kpi)
    R = Kpi // 32
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)
    cyc = np.roll(w[:Ncb], -(k0 % Ncb))
    valid = cyc[cyc >= 0]
    return np.tile(valid, -(-E // max(len(valid), 1)))[:E]


@functools.lru_cache(maxsize=64)
def conv_rm_indices(L: int, E: int) -> np.ndarray:
    """(E,) gather indices into flat d = concat(d0, d1, d2) of the
    tail-biting convolutional code (TS 36.212 §5.1.4.2), D = L per stream."""
    w = np.concatenate([np.where(v >= 0, v + i * L, -1)
                        for i, v in enumerate(_subblock(L, _P_CONV) for _ in range(3))])
    valid = w[w >= 0]
    return np.tile(valid, -(-E // len(valid)))[:E]


@functools.lru_cache(maxsize=256)
def turbo_rm_index_tensor(K: int, E: int, rv: int, F: int, device: torch.device) -> torch.Tensor:
    """turbo_rm_indices(K, E, rv, F=F) as a long tensor on `device`, cached."""
    return torch.as_tensor(turbo_rm_indices(K, E, rv, F=F), dtype=torch.long, device=device)


def rate_match_tx(d_flat: torch.Tensor, idx) -> torch.Tensor:
    """(B, 3D) coded bits + (E,) indices (numpy or a tensor) -> (B, E)
    selected bits."""
    return d_flat[:, torch.as_tensor(idx, dtype=torch.long, device=d_flat.device)]


def rate_match_rx(llr_e: torch.Tensor, idx, n3d: int, F: int = 0,
                  D: int = 0) -> torch.Tensor:
    """(B, E) received LLRs -> (B, 3D) soft-combined stream LLRs: repeated
    positions add (chase combining); the filler positions get the known-zero
    prior 1e4 (bit 0 -> +LLR)."""
    out = llr_e.new_zeros((llr_e.shape[0], n3d))
    out.index_add_(1, torch.as_tensor(idx, dtype=torch.long, device=llr_e.device), llr_e)
    if F:
        out[:, :F] = 1e4
        out[:, D: D + F] = 1e4
    return out


def cb_e_sizes(G: int, C: int, qm: int, n_layers: int = 1) -> list:
    """Per-code-block E (TS 36.212 §5.1.4.1.2)."""
    gp = G // (n_layers * qm)
    gamma = gp % C
    return [n_layers * qm * (gp // C) if r <= C - 1 - gamma
            else n_layers * qm * (-(-gp // C)) for r in range(C)]
