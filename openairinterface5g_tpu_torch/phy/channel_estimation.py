"""DMRS-based channel estimation: LS, smoothing, comb-2 interpolation.

Port of openairinterface5g_tpu/phy/channel_estimation.py: the window mode
(a moving average) and the delay mode (truncation in the delay domain).
"""
from __future__ import annotations

import numpy as np
import torch


def ls_estimate(y_pilots: torch.Tensor, pilots: torch.Tensor) -> torch.Tensor:
    """LS estimate at pilot positions: h = y * conj(r) (|r| = 1)."""
    return y_pilots * torch.conj(pilots)


def comb2_interpolate(h_pilots: torch.Tensor, n_sc: int, delta: int = 0) -> torch.Tensor:
    """Interpolate comb-2 pilot estimates (at SCs 2k+delta) to all n_sc SCs.

    Linear interpolation between pilots, edge-hold at the boundaries.
    h_pilots: (..., n_sc//2) -> (..., n_sc).
    """
    n_p = h_pilots.shape[-1]
    lead = h_pilots.shape[:-1]
    if delta == 0:
        right = torch.cat([h_pilots[..., 1:], h_pilots[..., -1:]], dim=-1)
        inter = torch.stack([h_pilots, 0.5 * (h_pilots + right)], dim=-1)
    else:
        mid_l = torch.cat([h_pilots[..., :1],
                           0.5 * (h_pilots[..., :-1] + h_pilots[..., 1:])], dim=-1)
        inter = torch.stack([mid_l, h_pilots], dim=-1)
    return inter.reshape(*lead, 2 * n_p)[..., :n_sc]


def freq_average(h: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Moving average over `window` subcarriers with replicate padding
    (window <= 1: off), as a cumulative-sum difference."""
    if window <= 1:
        return h
    pad = window // 2
    n = h.shape[-1]
    hp = torch.cat([h[..., :1].expand(*h.shape[:-1], pad), h,
                    h[..., -1:].expand(*h.shape[:-1], window - 1 - pad)], dim=-1)
    cs = torch.cumsum(hp, dim=-1)
    head = cs[..., window - 1: window - 1 + n]
    tail = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., : n - 1]], dim=-1)
    return (head - tail) / window


def noise_variance(y_pilots, h_pilots: torch.Tensor, pilots) -> torch.Tensor:
    """Noise variance from adjacent LS estimates (channel ~ constant over
    adjacent pilots): var = E|h[k] - h[k+1]|^2 / 2."""
    d = h_pilots[..., 1:] - h_pilots[..., :-1]
    return torch.mean(d.abs() ** 2, dim=-1) / 2.0


def estimate_slot(rx_grid_pilotsyms: torch.Tensor, pilots: torch.Tensor,
                  pilot_sc: np.ndarray, n_sc: int, delta: int = 0):
    """Channel estimate for one DMRS symbol.

    rx_grid_pilotsyms: (..., n_sc) received frequency-domain symbol holding
    the DMRS; pilots: (n_pilots,) reference sequence; pilot_sc: (n_pilots,)
    subcarrier indices.  Returns (h_full (..., n_sc), nvar (...)).
    """
    yp = rx_grid_pilotsyms[..., torch.as_tensor(pilot_sc, device=rx_grid_pilotsyms.device)]
    hp = ls_estimate(yp, pilots)
    h = comb2_interpolate(hp, n_sc, delta)
    nvar = noise_variance(yp, hp, pilots)
    return h, nvar


def delay_domain_denoise(hp: torch.Tensor, keep_frac: float = 0.1,
                         guard_frac: float = 0.02) -> torch.Tensor:
    """Denoise pilot-domain LS estimates (..., P) by truncation in the delay
    domain: IDFT, keep the taps within the CP span (the first keep_frac of
    P) and a small negative guard for timing error (the last guard_frac),
    zero the rest, DFT back."""
    P = hp.shape[-1]
    keep = max(1, int(np.ceil(keep_frac * P)))
    guard = max(1, int(np.ceil(guard_frac * P)))
    mask = torch.zeros(P, dtype=torch.float32, device=hp.device)
    mask[:keep] = 1.0
    mask[P - guard:] = 1.0
    g = torch.fft.ifft(hp, dim=-1) * mask
    return torch.fft.fft(g, dim=-1).to(hp.dtype)
