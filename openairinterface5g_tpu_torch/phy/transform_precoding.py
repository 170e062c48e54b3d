"""Transform precoding (DFT-s-OFDM), TS 38.211 §6.3.1.4.

Port of openairinterface5g_tpu/phy/transform_precoding.py: the spread and
despread are orthonormal ``torch.fft`` transforms over each symbol's
M_sc = 12 * n_prb subcarriers; the receiver divides per RE (zero forcing)
before the IDFT and hands the LLR stage the harmonic mean of the gains.
"""
from __future__ import annotations

import torch


def dft_spread(symbols: torch.Tensor, msc: int) -> torch.Tensor:
    """(..., n_sym*msc) modulated symbols -> DFT-spread frequency symbols."""
    lead = symbols.shape[:-1]
    y = torch.fft.fft(symbols.reshape(*lead, -1, msc), dim=-1, norm="ortho")
    return y.reshape(*lead, -1).to(torch.complex64)


def idft_despread(x_mf: torch.Tensor, mag: torch.Tensor, msc: int):
    """Inverse at the receiver on matched-filter outputs.

    x_mf: (..., n_sym*msc) compensated symbols (|H|^2-weighted), mag: the
    same-shaped |H|^2.  Per-RE division, IDFT, then the harmonic mean of
    mag over each spread block as the effective gain.  Returns (d, mag_eff),
    both (..., n_sym*msc): d the compensated time-domain symbols.
    """
    lead = x_mf.shape[:-1]
    mag_c = torch.clamp(mag, min=1e-12)
    xf = (x_mf / mag_c).reshape(*lead, -1, msc)
    d = torch.fft.ifft(xf, dim=-1, norm="ortho")
    # post-ZF noise per output sample ~ mean(1/mag): the effective gain is
    # the harmonic mean of mag across the spread block
    hmean = msc / torch.sum(1.0 / mag_c.reshape(*lead, -1, msc), dim=-1)
    mag_eff = hmean[..., None].expand(d.shape).reshape(*lead, -1)
    d = d.reshape(*lead, -1) * mag_eff
    return d.to(torch.complex64), mag_eff.to(torch.float32)
