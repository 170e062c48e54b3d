"""LTE SRS (TS 36.211 §5.5.3): wideband sounding in the last symbol of the
subframe, comb-2, a Zadoff-Chu base with the UE's cyclic shift.

Port of openairinterface5g_tpu/lte/srs.py (the reference's
srs_modulation.c and the eNB's channel-sounding estimate).  The RX returns
the per-subcarrier LS estimate and the wideband SNR that the MAC's link
adaptation reads, with the noise from adjacent-estimate differences.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..phy.refsig import low_papr_sequence


@dataclasses.dataclass(frozen=True)
class LteSrsConfig:
    n_rb: int = 25
    srs_rb: int = 24               # sounded bandwidth (multiple of 4)
    rb_start: int = 0
    cell_id: int = 0
    cyclic_shift: int = 0          # n_srs_cs (0..7)
    comb: int = 0                  # transmissionComb kTC=2
    n_rx: int = 1

    @property
    def m_sc(self) -> int:
        return self.srs_rb * 12 // 2        # comb-2: every other SC

    def sequence_np(self) -> np.ndarray:
        r = low_papr_sequence(self.cell_id % 30, 0, self.m_sc)
        alpha = 2 * np.pi * self.cyclic_shift / 8
        return (r * np.exp(1j * alpha * np.arange(self.m_sc))).astype(np.complex64)

    def sc_indices(self) -> np.ndarray:
        return 12 * self.rb_start + 2 * np.arange(self.m_sc) + self.comb


@functools.lru_cache(maxsize=32)
def _consts(cfg: LteSrsConfig, device: torch.device):
    return (torch.as_tensor(cfg.sc_indices(), device=device),
            torch.as_tensor(cfg.sequence_np(), device=device))


def srs_tx(cfg: LteSrsConfig, batch: int = 1, device: torch.device | str = "cpu") -> torch.Tensor:
    """-> (B, n_sc) REs of the SRS symbol (symbol 13 of the subframe)."""
    sc, seq = _consts(cfg, torch.device(device))
    grid = torch.zeros((batch, 12 * cfg.n_rb), dtype=torch.complex64, device=device)
    grid[:, sc] = seq
    return grid


def srs_rx(cfg: LteSrsConfig, y_sym: torch.Tensor) -> dict:
    """(B, n_rx, n_sc) received SRS symbol -> dict(h (B, R, m_sc), snr_db (B,),
    noise_var (B,))."""
    sc, seq = _consts(cfg, y_sym.device)
    h = y_sym[..., sc] * torch.conj(seq)
    d = h[..., 1:] - h[..., :-1]
    nvar = torch.mean(d.abs() ** 2, dim=(-2, -1)) / 2
    p = torch.mean(h.abs() ** 2, dim=(-2, -1))
    snr = 10.0 * torch.log10(torch.clamp(p - nvar, min=1e-12) / torch.clamp(nvar, min=1e-12))
    return {"h": h, "snr_db": snr, "noise_var": nvar}
