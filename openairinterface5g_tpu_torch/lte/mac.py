"""LTE eNB MAC scheduler: DL/UL allocation + HARQ + CQI link adaptation.

Compact functional analog of openair2/LAYER2/MAC (eNB side):
  - eNB_dlsch_ulsch_scheduler (eNB_scheduler.c:539) per-subframe entry
  - CQI -> MCS (36.213 §7.2.3 working points), BLER-target stepping
  - DL HARQ: 8 asynchronous processes, rv sequence {0, 2, 3, 1}
  - UL HARQ: synchronous, process id = subframe % 8 (FDD 8 ms timing,
    36.213 §8.0)
  - DCI grants packed as compact format-1A / format-0 style payloads
    for the lte.pdcch codec (dci_encode / pdcch_blind_decode)

A copy of openairinterface5g_tpu/lte/mac.py (pure Python and numpy; the
port imports nothing of the JAX package); tests/test_torch_lte_stack.py
holds the grants equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

HARQ_RV_SEQ = (0, 2, 3, 1)
N_HARQ = 8

# CQI (36.213 Table 7.2.3-1) -> I_MCS working points (table 8.6.1-1 class)
_CQI_TO_MCS = [0, 0, 0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 28]

# compact DCI payload (format 1A / format 0 field subset), MSB first
_DCI_FIELDS = (("mcs", 5), ("prb_start", 7), ("n_prb", 7), ("ndi", 1),
               ("rv", 2), ("harq_id", 3))
DCI_A = sum(b for _, b in _DCI_FIELDS)


def pack_dci(**vals) -> np.ndarray:
    bits = []
    for name, nb in _DCI_FIELDS:
        v = int(vals[name])
        bits.extend((v >> (nb - 1 - i)) & 1 for i in range(nb))
    return np.array(bits, np.int8)


def unpack_dci(bits) -> dict:
    out, i = {}, 0
    for name, nb in _DCI_FIELDS:
        v = 0
        for _ in range(nb):
            v = (v << 1) | int(bits[i])
            i += 1
        out[name] = v
    return out


def cqi_to_mcs(cqi: int, offset: int = 0) -> int:
    return max(0, min(28, _CQI_TO_MCS[max(0, min(15, cqi))] + offset))


@dataclasses.dataclass
class LteHarq:
    active: bool = False
    round: int = 0
    mcs: int = 0
    prbs: tuple = (0, 0)
    tb: object = None             # retransmission payload (DL)

    @property
    def rv(self) -> int:
        return HARQ_RV_SEQ[self.round % 4]


@dataclasses.dataclass
class LteUeState:
    rnti: int
    cqi: int = 9
    mcs_offset: int = 0
    bler_ewma: float = 0.0
    dl_harq: list = dataclasses.field(
        default_factory=lambda: [LteHarq() for _ in range(N_HARQ)])
    ul_harq: list = dataclasses.field(
        default_factory=lambda: [LteHarq() for _ in range(N_HARQ)])

    def free_dl_harq(self) -> Optional[int]:
        for i, h in enumerate(self.dl_harq):
            if not h.active:
                return i
        return None


@dataclasses.dataclass
class EnbSchedulerConfig:
    n_rb: int = 25
    target_bler: float = 0.3


class EnbScheduler:
    """Per-subframe eNB scheduler (eNB_dlsch_ulsch_scheduler analog)."""

    def __init__(self, cfg: EnbSchedulerConfig):
        self.cfg = cfg
        self.ues: dict[int, LteUeState] = {}

    def add_ue(self, rnti: int, **kw) -> LteUeState:
        ue = LteUeState(rnti=rnti, **kw)
        self.ues[rnti] = ue
        return ue

    def _adapt(self, ue: LteUeState, ok: bool):
        ue.bler_ewma = (1 - 0.1) * ue.bler_ewma + 0.1 * (0.0 if ok else 1.0)
        if ue.bler_ewma > self.cfg.target_bler * 1.5:
            ue.mcs_offset = max(-6, ue.mcs_offset - 1)
            ue.bler_ewma = self.cfg.target_bler
        elif ue.bler_ewma < self.cfg.target_bler * 0.3:
            ue.mcs_offset = min(2, ue.mcs_offset + 1)
            ue.bler_ewma = self.cfg.target_bler * 0.75

    # ---- feedback ----

    def on_dl_ack(self, rnti: int, harq_id: int, ack: bool):
        ue = self.ues[rnti]
        h = ue.dl_harq[harq_id]
        self._adapt(ue, ack)
        if ack:
            h.active = False
            h.round = 0
        else:
            h.round += 1
            if h.round >= 4:
                h.active, h.round = False, 0

    def on_ulsch_crc(self, rnti: int, subframe: int, ok: bool):
        ue = self.ues[rnti]
        h = ue.ul_harq[subframe % N_HARQ]     # synchronous UL HARQ
        self._adapt(ue, ok)
        if ok:
            h.active, h.round = False, 0
        else:
            h.round += 1
            if h.round >= 4:
                h.active, h.round = False, 0

    def on_cqi(self, rnti: int, cqi: int):
        self.ues[rnti].cqi = cqi

    # ---- per-subframe scheduling ----

    def schedule_dl(self, rnti: int) -> dict:
        """One DL allocation (full-buffer): retransmission first, else a
        new TB on a free process.  Returns the DCI field dict."""
        ue = self.ues[rnti]
        for hid, h in enumerate(ue.dl_harq):
            if h.active and h.round > 0:
                return dict(mcs=h.mcs, prb_start=h.prbs[0], n_prb=h.prbs[1],
                            ndi=0, rv=h.rv, harq_id=hid)
        hid = ue.free_dl_harq()
        mcs = cqi_to_mcs(ue.cqi, ue.mcs_offset)
        h = ue.dl_harq[hid]
        h.active, h.round, h.mcs, h.prbs = True, 0, mcs, (0, self.cfg.n_rb)
        return dict(mcs=mcs, prb_start=0, n_prb=self.cfg.n_rb, ndi=1, rv=0,
                    harq_id=hid)

    def schedule_ul(self, rnti: int, subframe: int) -> dict:
        """UL grant for `subframe` (synchronous HARQ: process = sf % 8)."""
        ue = self.ues[rnti]
        h = ue.ul_harq[subframe % N_HARQ]
        if h.active and h.round > 0:
            return dict(mcs=h.mcs, prb_start=h.prbs[0], n_prb=h.prbs[1],
                        ndi=0, rv=h.rv, harq_id=subframe % N_HARQ)
        mcs = cqi_to_mcs(ue.cqi, ue.mcs_offset)
        h.active, h.round, h.mcs, h.prbs = True, 0, mcs, (0, self.cfg.n_rb)
        return dict(mcs=mcs, prb_start=0, n_prb=self.cfg.n_rb, ndi=1, rv=0,
                    harq_id=subframe % N_HARQ)
