"""2-layer maximum-likelihood joint-LLR MIMO detector (rho-aware).

Port of openairinterface5g_tpu/phy/ml_detector.py, the analog of the
reference's interference-aware 2-stream LLRs (nr_ulsch_qpsk_qpsk,
nr_ulsch_llr_computation.c:375).  For every symbol pair (s0, s1) of the
constellation the max-log metric

  D(s0, s1) = a00|s0|^2 + a11|s1|^2 + 2Re(s0* rho s1) - 2Re(s0* r0 + s1* r1)

(r_l = h_l^H y, a_ll = ||h_l||^2, rho = h_0^H h_1: ||y - H s||^2 up to
|y|^2) is one broadcast over (batch, RE, Q, Q), Q = 2^qm, one data symbol
at a time; LLR(bit b) = min over pairs with b = 1 - min over pairs with
b = 0, scaled by 1/nvar (> 0 means bit 0).  A layer-0 bit depends only on
the first point of the pair, so the metric is first minimized over the
other layer's point and then per bit: the same minima as masking the
whole pair grid per bit, with two reductions of the (B, M, Q, Q) metric
instead of 2*qm.

Memory: one symbol's metric is B * M * Q^2 float32 (about 0.86 GB at
256QAM, 273 PRB, B = 1), plus the pair-independent part of the same size.
The largest the card ran: 16QAM at 106 PRB, B = 16 (chip_smoke.py phase 8,
the nr_ulsim.mimo 2-layer point at MCS 10 with --receiver ml).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .modulation import constellation


@functools.lru_cache(maxsize=8)
def _pair_tables(qm: int):
    """Per-constellation host tables: points s (Q,), energies |s|^2 (Q,),
    s0* s1 over the pair grid (Q, Q), and bit k of each point (qm, Q)."""
    s = constellation(qm)
    Q = len(s)
    e = (np.abs(s) ** 2).astype(np.float32)
    cross = (np.conj(s)[:, None] * s[None, :]).astype(np.complex64)
    bits = ((np.arange(Q)[None, :] >> (qm - 1 - np.arange(qm))[:, None]) & 1).astype(bool)
    return s.astype(np.complex64), e, cross, bits


def _bit_llrs(dmin: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(..., Q) metric minimized over the other layer -> (..., qm): min over
    points with bit k = 1 minus min over points with bit k = 0."""
    big = torch.finfo(dmin.dtype).max
    d = dmin[..., None, :]                                # (..., 1, Q)
    m1 = torch.where(bits, d, big).amin(dim=-1)
    m0 = torch.where(bits, big, d).amin(dim=-1)
    return m1 - m0


def ml_llrs_2layer(h: torch.Tensor, y: torch.Tensor, qm: int,
                   nvar: torch.Tensor) -> torch.Tensor:
    """Joint max-log LLRs of a 2-layer transmission.

    h: (B, R, 2, M) per-subcarrier channel (block fading over the symbols),
    y: (B, R, S, M) received data REs, nvar: (B,) noise variance.
    Returns (B, 2, S, M, qm) LLRs (layer, symbol, subcarrier, bit).
    """
    s_np, e_np, cross_np, bits_np = _pair_tables(qm)
    dev = y.device
    s = torch.as_tensor(s_np, device=dev)
    e = torch.as_tensor(e_np, device=dev)
    cross = torch.as_tensor(cross_np, device=dev)
    bits = torch.as_tensor(bits_np, device=dev)
    h0, h1 = h[:, :, 0], h[:, :, 1]                       # (B, R, M)
    a00 = torch.sum(h0.abs() ** 2, dim=1)                 # (B, M)
    a11 = torch.sum(h1.abs() ** 2, dim=1)
    rho = torch.sum(torch.conj(h0) * h1, dim=1)           # (B, M)
    r0 = torch.einsum("brm,brsm->bsm", torch.conj(h0), y)  # (B, S, M)
    r1 = torch.einsum("brm,brsm->bsm", torch.conj(h1), y)
    # pair-independent part: (B, M, Q, Q)
    base = (a00[..., None, None] * e[:, None] + a11[..., None, None] * e[None, :]
            + 2.0 * (rho[..., None, None] * cross).real)
    sc = torch.conj(s)
    out = []
    for si in range(y.shape[2]):                          # one data symbol at a time
        t0 = 2.0 * (sc * r0[:, si, :, None]).real         # (B, M, Q)
        t1 = 2.0 * (sc * r1[:, si, :, None]).real
        D = base - (t0[..., :, None] + t1[..., None, :])
        llr0 = _bit_llrs(D.amin(dim=-1), bits)            # layer 0: min over s1
        llr1 = _bit_llrs(D.amin(dim=-2), bits)            # layer 1: min over s0
        out.append(torch.stack([llr0, llr1], dim=-2))     # (B, M, 2, qm)
    llr = torch.stack(out, dim=1)                         # (B, S, M, 2, qm)
    llr = llr * (1.0 / torch.clamp(nvar, min=1e-12))[:, None, None, None, None]
    return llr.permute(0, 3, 1, 2, 4)                     # (B, 2, S, M, qm)
