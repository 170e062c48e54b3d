"""TDD UL/DL slot patterns (TS 38.213 §11.1 tdd-UL-DL-ConfigCommon).

The reference builds a per-slot symbol bitmap from the RRC pattern
(openair2/LAYER2/NR_MAC_COMMON/nr_mac_common.c set_tdd_config_nr /
gNB_scheduler.c is_xlsch_in_slot); here the pattern is a typed config
producing a static slot-direction map the softmodem loop indexes —
static per configuration, so every slot program keeps static shapes.

Also carries the LTE TDD frame structure type 2 subframe patterns
(TS 36.211 Table 4.2-2) for the legacy stack.

A copy of openairinterface5g_tpu/runtime/tdd.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TddConfig:
    """tdd-UL-DL-ConfigCommon pattern1 analog."""

    mu: int = 1
    periodicity_ms: float = 5.0      # dl-UL-TransmissionPeriodicity
    nrof_dl_slots: int = 7           # leading full-DL slots
    nrof_dl_symbols: int = 6         # DL symbols of the mixed slot
    nrof_ul_slots: int = 2           # trailing full-UL slots
    nrof_ul_symbols: int = 4         # UL symbols of the mixed slot

    @property
    def period_slots(self) -> int:
        n = self.periodicity_ms * (1 << self.mu)
        assert abs(n - round(n)) < 1e-9, "periodicity must be whole slots"
        return int(round(n))

    def __post_init__(self):
        assert (self.nrof_dl_slots + self.nrof_ul_slots < self.period_slots
                or (self.nrof_dl_slots + self.nrof_ul_slots
                    == self.period_slots
                    and self.nrof_dl_symbols == self.nrof_ul_symbols == 0))
        assert self.nrof_dl_symbols + self.nrof_ul_symbols <= 14

    def slot_type(self, slot: int) -> str:
        """'D' | 'U' | 'S' (mixed/special) for an absolute slot index."""
        p = slot % self.period_slots
        if p < self.nrof_dl_slots:
            return "D"
        if p >= self.period_slots - self.nrof_ul_slots:
            return "U"
        if (p == self.nrof_dl_slots
                and (self.nrof_dl_symbols or self.nrof_ul_symbols)):
            return "S"
        return "S" if self.nrof_dl_slots + self.nrof_ul_slots \
            < self.period_slots else "U"

    def pattern(self) -> str:
        """One period as a 'DDD..SUU' string (gNB log format)."""
        return "".join(self.slot_type(s) for s in range(self.period_slots))

    def mixed_slot_symbols(self) -> tuple:
        """(dl_symbol_ids, ul_symbol_ids) of the mixed slot: leading DL
        symbols, trailing UL symbols, flexible gap between."""
        dl = tuple(range(self.nrof_dl_symbols))
        ul = tuple(range(14 - self.nrof_ul_symbols, 14))
        return dl, ul

    @classmethod
    def from_string(cls, spec: str, mu: int = 1) -> "TddConfig":
        """'7,6,2,4[,5.0]' = dlSlots,dlSyms,ulSlots,ulSyms[,period_ms]."""
        f = [float(v) for v in spec.split(",")]
        period = f[4] if len(f) > 4 else 5.0
        return cls(mu=mu, periodicity_ms=period, nrof_dl_slots=int(f[0]),
                   nrof_dl_symbols=int(f[1]), nrof_ul_slots=int(f[2]),
                   nrof_ul_symbols=int(f[3]))


# LTE frame structure type 2 (TS 36.211 Table 4.2-2): per-subframe
# direction for uplink-downlink configurations 0-6 (S = special)
LTE_TDD_CONFIGS = {
    0: "DSUUUDSUUU",
    1: "DSUUDDSUUD",
    2: "DSUDDDSUDD",
    3: "DSUUUDDDDD",
    4: "DSUUDDDDDD",
    5: "DSUDDDDDDD",
    6: "DSUUUDSUUD",
}


def lte_tdd_counts(config: int) -> tuple:
    """(n_dl, n_special, n_ul) subframes per 10 ms frame."""
    p = LTE_TDD_CONFIGS[config]
    return p.count("D"), p.count("S"), p.count("U")
