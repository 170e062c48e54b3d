"""MU-MIMO: two UEs co-scheduled on the same PRBs through orthogonal
codebook precoders.

Port of openairinterface5g_tpu/models/mu_mimo.py.  Each UE's 1-layer PDSCH
grid comes from pusch_tx_grid (its own RNTI scrambling and DMRS port), is
precoded by its codebook column, and the two 2-port grids are summed before
one OFDM pass.  The receiving UE estimates both ports jointly, suppresses
the other UE by MMSE, keeps its own layer and decodes it with its
configuration's decoder.  Pairing (mu_pair_select) takes the orthogonal
pair that maximizes the weaker UE's codebook gain.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from .csirs import PMI_CODEBOOK_2TX
from .pdsch import PdschConfig
from .pusch import (_mmse_over_syms, pusch_channel_estimate, pusch_decode_codeword,
                    pusch_llrs, pusch_tx_grid)

# orthogonal codebook pairs: <W_i, W_j> = 0
_ORTHO_PAIRS = tuple((i, j) for i in range(4) for j in range(4)
                     if i != j and abs(np.vdot(PMI_CODEBOOK_2TX[i],
                                               PMI_CODEBOOK_2TX[j])) < 1e-6)


def mu_pair_select(gain1, gain2) -> tuple[int, int]:
    """Per-UE codebook gains (4,) -> the orthogonal (pmi1, pmi2) that
    maximizes the weaker UE's post-precoding power (max-min pairing)."""
    best, best_m = _ORTHO_PAIRS[0], -1.0
    for (i, j) in _ORTHO_PAIRS:
        m = min(float(gain1[i]), float(gain2[j]))
        if m > best_m:
            best, best_m = (i, j), m
    return best


def mu_cfgs(n_prb: int, rnti1: int, rnti2: int, n_rx: int = 2, mcs: int = 9,
            n_bwp_prb: int | None = None):
    """Per-UE PDSCH configurations sharing the allocation: DMRS ports 0 / 1."""
    common = dict(mu=1, n_prb=n_prb, mcs=mcs, n_layers=1, n_rx=n_rx,
                  n_bwp_prb=n_bwp_prb, start_symbol=2, n_symbols=12, dmrs_symbols=(2,))
    return (PdschConfig(rnti=rnti1, dmrs_port0=0, **common),
            PdschConfig(rnti=rnti2, dmrs_port0=1, **common))


def mu_mimo_tx(cfg1: PdschConfig, cfg2: PdschConfig, tb1: torch.Tensor, tb2: torch.Tensor,
               pmi1: int, pmi2: int) -> torch.Tensor:
    """Two 1-layer streams superposed on 2 TX ports -> (B, 2, samples)."""
    g1, _ = pusch_tx_grid(cfg1, tb1)                       # (B, 1, S, n_sc)
    g2, _ = pusch_tx_grid(cfg2, tb2)
    W = torch.as_tensor(PMI_CODEBOOK_2TX, dtype=torch.complex64, device=g1.device)
    gw = (torch.einsum("al,blsk->bask", W[pmi1][:, None], g1)
          + torch.einsum("al,blsk->bask", W[pmi2][:, None], g2))
    fp = cfg1.fp
    return ofdm_modulate(fp, map_to_grid(fp, gw), cfg1.slot)


def mu_mimo_rx(cfg_own: PdschConfig, own_port: int, rx_samples: torch.Tensor,
               n_iters: int = 10) -> dict:
    """One UE's receive: the joint 2-port estimate of the effective channels
    (its own precoded stream on its DMRS port, the other UE's on the other
    port), MMSE, its own layer's LLRs, and the decode."""
    fp = cfg_own.fp
    re_grid = extract_from_grid(fp, ofdm_demodulate(fp, rx_samples, cfg_own.slot))
    base = dataclasses.replace(cfg_own, dmrs_port0=0, n_layers=1)
    h, nvar = pusch_channel_estimate(base, re_grid, n_ports=2)
    m, a0 = 12 * cfg_own.n_prb, cfg_own.sc0
    y = re_grid[:, :, list(cfg_own.data_symbols), a0: a0 + m]
    x, mag = _mmse_over_syms(h, y, nvar)                   # (B, 2, S, M)
    own = slice(own_port, own_port + 1)
    llr_cw = pusch_llrs(cfg_own, re_grid, x[:, own], mag[:, own], h)
    return pusch_decode_codeword(cfg_own, llr_cw, n_iters=n_iters)
