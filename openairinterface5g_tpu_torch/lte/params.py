"""LTE frame parameters and subframe OFDM (TS 36.211 §6.2, §6.12).

Port of openairinterface5g_tpu/lte/params.py (lte_parms.c, PHY_ofdm_mod and
the slot FEP for the 4G numerology): 15 kHz subcarriers, 0.5 ms slots of 7
symbols (normal CP), processed per 1 ms subframe (14 symbols) as one
batched FFT.  The DC subcarrier stays empty.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# n_rb -> FFT size (TS 36.101 bandwidths 1.4/3/5/10/15/20 MHz)
_LTE_FFT = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}


@dataclasses.dataclass(frozen=True)
class LteFrameParams:
    """Static subframe geometry (normal CP)."""

    n_rb: int
    fft_size: int
    symbols_per_slot: int = 7          # normal CP

    @property
    def n_sc(self) -> int:
        return 12 * self.n_rb

    @property
    def sample_rate(self) -> float:
        return float(self.fft_size * 15_000)

    @property
    def symbols_per_subframe(self) -> int:
        return 2 * self.symbols_per_slot

    @property
    def cp_samples(self) -> int:
        """Normal CP (symbols 1..6 of each slot): 144 at FFT 2048."""
        return self.fft_size * 144 // 2048

    @property
    def cp0_samples(self) -> int:
        """First-symbol CP of each slot: 160 at FFT 2048."""
        return self.fft_size * 160 // 2048

    def cp_lengths(self) -> np.ndarray:
        """(14,) CP length per subframe symbol."""
        cps = np.full(self.symbols_per_subframe, self.cp_samples, np.int64)
        cps[0] = cps[self.symbols_per_slot] = self.cp0_samples
        return cps

    @property
    def samples_per_subframe(self) -> int:
        return int(self.cp_lengths().sum()) + self.fft_size * self.symbols_per_subframe

    def symbol_offsets(self) -> np.ndarray:
        sizes = self.cp_lengths() + self.fft_size
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    @property
    def first_carrier(self) -> int:
        """FFT bin of the lowest occupied subcarrier: bins first_carrier..-1
        carry the negative frequencies, 1..n_sc/2 the positive ones."""
        return self.fft_size - self.n_sc // 2


@functools.lru_cache(maxsize=8)
def make_lte_frame_params(n_rb: int) -> LteFrameParams:
    return LteFrameParams(n_rb=n_rb, fft_size=_LTE_FFT[n_rb])


@functools.lru_cache(maxsize=8)
def _sc_to_bin(fp: LteFrameParams) -> np.ndarray:
    half = fp.n_sc // 2
    return np.concatenate([fp.first_carrier + np.arange(half), 1 + np.arange(half)])


def map_to_grid(fp: LteFrameParams, re_values: torch.Tensor) -> torch.Tensor:
    """(..., 14, n_sc) REs -> (..., 14, fft) grid, DC skipped."""
    grid = re_values.new_zeros((*re_values.shape[:-1], fp.fft_size))
    grid[..., torch.as_tensor(_sc_to_bin(fp), device=re_values.device)] = re_values
    return grid


def extract_from_grid(fp: LteFrameParams, grid: torch.Tensor) -> torch.Tensor:
    """Inverse of map_to_grid."""
    return grid[..., torch.as_tensor(_sc_to_bin(fp), device=grid.device)]


def ofdm_modulate(fp: LteFrameParams, grid: torch.Tensor) -> torch.Tensor:
    """(..., 14, fft) frequency grid -> (..., samples) subframe."""
    x = torch.fft.ifft(grid, dim=-1).to(torch.complex64) * np.sqrt(np.float32(fp.fft_size))
    cps = fp.cp_lengths()
    parts = []
    for sym in range(fp.symbols_per_subframe):
        parts += [x[..., sym, -int(cps[sym]):], x[..., sym, :]]
    return torch.cat(parts, dim=-1)


def ofdm_demodulate(fp: LteFrameParams, samples: torch.Tensor) -> torch.Tensor:
    """(..., samples) subframe -> (..., 14, fft) frequency grid."""
    starts = fp.symbol_offsets() + fp.cp_lengths()
    x = torch.stack([samples[..., int(s): int(s) + fp.fft_size] for s in starts], dim=-2)
    return torch.fft.fft(x, dim=-1).to(torch.complex64) / np.sqrt(np.float32(fp.fft_size))
