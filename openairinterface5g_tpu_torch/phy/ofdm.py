"""OFDM modulation/demodulation: batched (I)FFT + cyclic prefix.

Port of openairinterface5g_tpu/phy/ofdm.py with ``torch.fft``.  Frequency
grids are (..., symbols, fft_size) in FFT order (DC at bin 0, negative
frequencies wrapped); both directions keep the unitary sqrt(N) scaling.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FrameParams


def map_to_grid(fp: FrameParams, re_values: torch.Tensor) -> torch.Tensor:
    """(..., symbols, n_sc) occupied REs -> (..., symbols, fft_size) grid.

    RE k (k = 0 lowest PRB) lands at FFT bin (first_carrier + k) % fft_size.
    """
    lead = re_values.shape[:-1]
    n_hi = fp.fft_size - fp.first_carrier     # REs in the upper (neg-freq) bins
    zeros = re_values.new_zeros((*lead, fp.fft_size - fp.n_sc))
    return torch.cat([re_values[..., n_hi:], zeros, re_values[..., :n_hi]], dim=-1)


def extract_from_grid(fp: FrameParams, grid: torch.Tensor) -> torch.Tensor:
    """Inverse of map_to_grid."""
    n_hi = fp.fft_size - fp.first_carrier
    return torch.cat([grid[..., fp.first_carrier:], grid[..., : fp.n_sc - n_hi]], dim=-1)


def _cp_segments(cps: np.ndarray):
    """Runs (l0, l1, cp) of consecutive symbols sharing a CP length."""
    segs, l = [], 0
    while l < len(cps):
        r = l + 1
        while r < len(cps) and cps[r] == cps[l]:
            r += 1
        segs.append((l, r, int(cps[l])))
        l = r
    return segs


def ofdm_modulate(fp: FrameParams, grid: torch.Tensor, slot: int) -> torch.Tensor:
    """(..., symbols, fft) frequency grid -> (..., samples) time-domain slot."""
    x = torch.fft.ifft(grid, dim=-1).to(torch.complex64) * np.float32(math.sqrt(fp.fft_size))
    lead = x.shape[:-2]
    parts = []
    for (l0, l1, cp) in _cp_segments(fp.cp_lengths(slot)):
        seg = x[..., l0:l1, :]
        withcp = torch.cat([seg[..., -cp:], seg], dim=-1)
        parts.append(withcp.reshape(*lead, (l1 - l0) * (cp + fp.fft_size)))
    return torch.cat(parts, dim=-1)


def ofdm_demodulate(fp: FrameParams, samples: torch.Tensor, slot: int) -> torch.Tensor:
    """(..., samples) time-domain slot -> (..., symbols, fft) frequency grid."""
    offs = fp.symbol_offsets(slot)
    lead = samples.shape[:-1]
    segs = []
    for (l0, l1, cp) in _cp_segments(fp.cp_lengths(slot)):
        start = int(offs[l0])
        width = (cp + fp.fft_size) * (l1 - l0)
        chunk = samples[..., start: start + width].reshape(*lead, l1 - l0, cp + fp.fft_size)
        segs.append(chunk[..., cp:])
    x = torch.cat(segs, dim=-2)
    return torch.fft.fft(x, dim=-1).to(torch.complex64) / np.float32(math.sqrt(fp.fft_size))


def symbol_rotation(fp: FrameParams, slot: int, f0: float) -> np.ndarray:
    """Per-symbol phase compensation e^{-j 2 pi f0 t_l} (TS 38.211 §5.4).

    Each OFDM symbol l starting at sample offset t_l (CP included) accrues
    the upconversion phase 2 pi f0 t_l at carrier offset f0 (the reference's
    init_symbol_rotation, nr_modulation.c:587).  Returns (symbols_per_slot,)
    complex64, a host table.
    """
    offs = fp.symbol_offsets(slot) + fp.cp_lengths(slot)
    t = offs / fp.sample_rate
    return np.exp(-2j * np.pi * f0 * t).astype(np.complex64)


def apply_rotation_tx(fp: FrameParams, grid: torch.Tensor, slot: int, f0: float) -> torch.Tensor:
    """Apply the TX symbol rotation to a (..., symbols, fft) frequency grid."""
    if f0 == 0.0:
        return grid
    rot = torch.as_tensor(symbol_rotation(fp, slot, f0), device=grid.device)
    return grid * rot[:, None]


def apply_rotation_rx(fp: FrameParams, grid: torch.Tensor, slot: int, f0: float) -> torch.Tensor:
    """Undo the TX rotation at RX (its conjugate)."""
    if f0 == 0.0:
        return grid
    rot = torch.as_tensor(np.conj(symbol_rotation(fp, slot, f0)), device=grid.device)
    return grid * rot[:, None]
