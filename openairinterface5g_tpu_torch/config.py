"""NR numerology / frame parameters (TS 38.211 §4-5).

The port's own copy of the part of openairinterface5g_tpu/config.py it
uses (``FrameParams``, ``fft_size_for_rb``, ``make_frame_params``,
``CONFIGS``), so that
it imports nothing of the JAX package.  All values are host-side Python
ints.  tests/test_torch_pusch.py holds it against the original.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

# FFT sizes supported (incl. the 3x2^k sizes for 100 MHz-class bandwidths)
_FFT_SIZES = (128, 256, 512, 1024, 1536, 2048, 3072, 4096, 6144, 8192)


def fft_size_for_rb(n_rb: int) -> int:
    """Smallest supported FFT size strictly greater than the occupied SCs."""
    n_sc = 12 * n_rb
    for n in _FFT_SIZES:
        if n > n_sc:
            return n
    raise ValueError(f"n_rb={n_rb} too large")


@dataclasses.dataclass(frozen=True)
class FrameParams:
    """Static slot geometry for one (mu, n_rb) numerology."""

    mu: int                 # subcarrier spacing exponent: SCS = 15*2^mu kHz
    n_rb: int               # resource blocks (bandwidth)
    fft_size: int
    symbols_per_slot: int = 14  # normal CP

    @property
    def scs(self) -> int:
        return 15_000 * (1 << self.mu)

    @property
    def sample_rate(self) -> float:
        return float(self.fft_size * self.scs)

    @property
    def n_sc(self) -> int:
        return 12 * self.n_rb

    @property
    def slots_per_subframe(self) -> int:
        return 1 << self.mu

    @property
    def slots_per_frame(self) -> int:
        return 10 << self.mu

    @property
    def cp_samples(self) -> int:
        """Normal CP length in samples (all but the long-CP symbols)."""
        return self.fft_size * 144 // 2048

    @property
    def cp0_samples(self) -> int:
        """Long CP (first symbol of each half-subframe)."""
        return self.cp_samples + self.fft_size * (1 << self.mu) // 128

    def cp_lengths(self, slot: int) -> np.ndarray:
        """(symbols_per_slot,) CP length per symbol of `slot`: long CP on
        absolute symbols 0 and 7*2^mu within each subframe (TS 38.211 5.3.1)."""
        sps = self.symbols_per_slot
        first_abs = (slot % self.slots_per_subframe) * sps
        cps = np.full(sps, self.cp_samples, dtype=np.int64)
        for l_long in (0, 7 << self.mu):
            if first_abs <= l_long < first_abs + sps:
                cps[l_long - first_abs] = self.cp0_samples
        return cps

    def samples_per_slot(self, slot: int) -> int:
        return int(self.cp_lengths(slot).sum()) + self.fft_size * self.symbols_per_slot

    @property
    def samples_per_subframe(self) -> int:
        return sum(self.samples_per_slot(s) for s in range(self.slots_per_subframe))

    def symbol_offsets(self, slot: int) -> np.ndarray:
        """(symbols_per_slot,) sample offset of each symbol start (CP start)."""
        sizes = self.cp_lengths(slot) + self.fft_size
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    @property
    def first_carrier(self) -> int:
        """Index of the lowest occupied subcarrier in FFT order (negative
        frequencies wrap to the top half)."""
        return self.fft_size - self.n_sc // 2


@functools.lru_cache(maxsize=32)
def make_frame_params(mu: int, n_rb: int) -> FrameParams:
    return FrameParams(mu=mu, n_rb=n_rb, fft_size=fft_size_for_rb(n_rb))


# the named carrier configurations: (mu, n_rb)
CONFIGS = {
    "10MHz@15kHz": (0, 52),
    "20MHz@15kHz": (0, 106),
    "40MHz@30kHz": (1, 106),
    "60MHz@30kHz": (1, 162),
    "80MHz@30kHz": (1, 217),
    "100MHz@30kHz": (1, 273),
}
