"""LTE PRACH (TS 36.211 §5.7): ZC-839 preambles, formats 0-3.

Port of openairinterface5g_tpu/lte/prach.py (the reference's prach.c).  The
frequency-domain correlation engine is NR's (models/prach.py: the 839-point
ZC machinery is the same); this module adds the LTE numerology: the 1.25 kHz
preamble SCS, each format's sequence and CP durations, and the Ncs of the
unrestricted set.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.lte_tables import PRACH_ROOT_MAP_0_3, PRACH_ROOT_MAP_4
from ..models import prach as nr_prach

# T_CP / T_SEQ in Ts units (36.211 Table 5.7.1-1); Ts = 1/30.72e6
FORMATS = {
    0: (3168, 24576),
    1: (21024, 24576),
    2: (6240, 2 * 24576),
    3: (21024, 2 * 24576),
}

# Ncs by zeroCorrelationZoneConfig (36.211 Table 5.7.2-2, unrestricted set)
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119,
                    167, 279, 419)


@dataclasses.dataclass(frozen=True)
class LtePrachConfig:
    format: int = 0
    root_sequence_index: int = 0        # logical index -> physical roots
    zero_correlation_zone: int = 1      # index into NCS_UNRESTRICTED
    n_roots: int = 2                    # roots drawn from the logical table
    threshold: float = 10.0

    @property
    def n_cs(self) -> int:
        return NCS_UNRESTRICTED[self.zero_correlation_zone]

    @property
    def roots(self) -> tuple:
        """Physical roots u of logical indices i, i+1, ... (36.211 Table
        5.7.2-4 for formats 0-3, 5.7.2-5 for format 4), wrapping around."""
        table = PRACH_ROOT_MAP_4 if self.format == 4 else PRACH_ROOT_MAP_0_3
        return tuple(table[(self.root_sequence_index + i) % len(table)]
                     for i in range(self.n_roots))

    @property
    def engine(self) -> nr_prach.PrachConfig:
        return nr_prach.PrachConfig(l_ra=839, roots=self.roots, n_cs=self.n_cs, n_ifft=1024,
                                    threshold=self.threshold)

    @property
    def n_preambles(self) -> int:
        return len(self.roots) * self.engine.shifts_per_root

    def durations_ts(self) -> tuple:
        """(T_CP, T_SEQ) in Ts units for the format."""
        return FORMATS[self.format]


def prach_tx(cfg: LtePrachConfig, preamble_idx: torch.Tensor) -> torch.Tensor:
    """(B,) preamble indices -> (B, 839) frequency-domain preamble."""
    return nr_prach.prach_tx(cfg.engine, preamble_idx)


def prach_rx(cfg: LtePrachConfig, rx_freq: torch.Tensor) -> dict:
    """(B, n_rx, 839) -> detection dict (detected / preamble / delay / metric).

    The delay unit is one n_ifft-rate sample over the 839-SC window: 800 us /
    1024 = 0.78 us of round-trip time at format 0."""
    return nr_prach.prach_rx(cfg.engine, rx_freq)
