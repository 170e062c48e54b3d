"""PRS positioning (TS 38.211 §7.4.1.7, TS 38.215 §5.1): the TX staircase and
the UE's time-of-arrival and RSTD measurement.

Port of openairinterface5g_tpu/models/prs.py (nr_prs.c generates the PRS at
the gNB).  The staircase's comb offsets tile every subcarrier across one
period, so the pilot-compensated symbols merge into one channel estimate
over the band; a zero-padded IFFT gives the delay profile, and a 3-point
parabola refines its peak.  Float32 throughout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..phy import refsig


@dataclasses.dataclass(frozen=True)
class PrsConfig:
    n_prb: int = 24
    comb_size: int = 4
    re_offset: int = 0
    n_symbols: int = 4          # one staircase period = comb_size symbols
    start_symbol: int = 2
    n_id_prs: int = 0
    slot: int = 0

    @property
    def m_per_sym(self) -> int:
        return 12 * self.n_prb // self.comb_size


def _symbols(cfg: PrsConfig):
    """Per PRS symbol: (subcarriers (m,), pilots (m,) complex64), numpy."""
    offs = refsig.prs_staircase_offsets(cfg.comb_size, cfg.n_symbols, cfg.re_offset)
    out = []
    for li in range(cfg.n_symbols):
        cinit = refsig.prs_cinit(cfg.slot, cfg.start_symbol + li, cfg.n_id_prs)
        sc = np.arange(cfg.m_per_sym) * cfg.comb_size + int(offs[li])
        out.append((sc, refsig.prs_sequence(cinit, cfg.m_per_sym)))
    return out


def prs_tx_grid(cfg: PrsConfig, batch: int, n_sc: int,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """(B, n_symbols, n_sc) PRS staircase tile on `device`, zeros elsewhere."""
    rows = np.zeros((cfg.n_symbols, n_sc), np.complex64)
    for li, (sc, seq) in enumerate(_symbols(cfg)):
        rows[li, sc] = seq
    return torch.as_tensor(rows, device=device).expand(batch, cfg.n_symbols, n_sc)


def prs_toa(cfg: PrsConfig, rx_syms: torch.Tensor, fft_size: int, osf: int = 8) -> dict:
    """UE time of arrival from the PRS symbols' REs (B, n_rx, n_symbols, n_sc)
    -> dict(toa_samples (B,): the delay in samples at the carrier's rate,
    peak_power (B,), profile (B, osf * fft_size)).

    The IFFT is zero-padded to osf * fft_size; the peak is the first index of
    the largest bin, refined by a parabola through it and its neighbours.
    """
    B, R, _, n_sc = rx_syms.shape
    dev = rx_syms.device
    h = torch.zeros((B, R, n_sc), dtype=torch.complex64, device=dev)
    for li, (sc, seq) in enumerate(_symbols(cfg)):
        sc_t = torch.as_tensor(sc, device=dev)
        h[..., sc_t] = rx_syms[:, :, li, sc_t] * torch.conj(torch.as_tensor(seq, device=dev))
    n_fft = osf * fft_size
    prof = torch.fft.ifft(h, n=n_fft, dim=-1)
    p = torch.sum(prof.abs() ** 2, dim=1)                  # (B, n_fft)
    peak = torch.argmax(p, dim=-1)
    pm = p.gather(1, ((peak - 1) % n_fft)[:, None])[:, 0]
    p0 = p.gather(1, peak[:, None])[:, 0]
    pp = p.gather(1, ((peak + 1) % n_fft)[:, None])[:, 0]
    denom = torch.clamp(pm - 2 * p0 + pp, min=1e-12)
    frac = torch.clamp(0.5 * (pm - pp) / denom, -0.5, 0.5)
    # bin k of the n_fft IFFT is k / osf samples at the carrier's rate
    toa = (peak.to(torch.float32) + frac) * (fft_size / n_fft)
    # delays beyond half the window are negative aliases
    toa = torch.where(toa > fft_size / 2, toa - fft_size, toa)
    return {"toa_samples": toa, "peak_power": p0, "profile": p}


def rstd(cfg: PrsConfig, toa_a: torch.Tensor, toa_b: torch.Tensor) -> torch.Tensor:
    """Reference signal time difference (TS 38.215 §5.1.29)."""
    return toa_a - toa_b
