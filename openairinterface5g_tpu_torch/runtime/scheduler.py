"""MAC-lite scheduler: fixed-allocation per-UE slot scheduling + HARQ.

The phytest-mode analog (openair2/LAYER2/NR_MAC_gNB/gNB_scheduler_phytest.c
+ the HARQ rv sequence nr_rv_round_map, gNB_scheduler.c:56): every slot,
each configured UE gets its fixed PRB allocation; CRC indications drive
per-UE HARQ state (new TB on ACK, next redundancy version + LLR-buffer
combining on NACK).  This is deliberately not a PF scheduler — it is the
deterministic scheduler the reference uses for PHY testing.

A copy of openairinterface5g_tpu/runtime/scheduler.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..models.gnb import SlotUlConfig
from ..models.pusch import PuschConfig

HARQ_RV_SEQ = (0, 2, 3, 1)


@dataclasses.dataclass
class UeHarqState:
    round: int = 0              # 0 = new transmission
    buffers: Any = None         # per-CB LLR buffers from last rx
    acked: int = 0
    nacked: int = 0
    dtx: int = 0

    @property
    def rv(self) -> int:
        return HARQ_RV_SEQ[self.round % len(HARQ_RV_SEQ)]


@dataclasses.dataclass
class UeContext:
    cfg: PuschConfig
    harq: UeHarqState = dataclasses.field(default_factory=UeHarqState)


class PhytestScheduler:
    """Deterministic UL scheduler over a fixed set of UEs."""

    def __init__(self, ues: list[PuschConfig], max_rounds: int = 4):
        self.ues = [UeContext(cfg=c) for c in ues]
        self.max_rounds = max_rounds

    def schedule_slot(self, slot: int) -> tuple[SlotUlConfig, list[dict]]:
        """Build the UL_TTI.request analog for `slot`.

        Returns (SlotUlConfig, per-UE plan dicts with rv / harq buffers /
        new_data flags the PHY loop needs).
        """
        mu = self.ues[0].cfg.mu
        bwp = max(u.cfg.bwp_prbs for u in self.ues)
        plans = []
        cfgs = []
        for ue in self.ues:
            plans.append({
                "rv": ue.harq.rv,
                "new_data": ue.harq.round == 0,
                "harq_buffers": ue.harq.buffers,
            })
            cfgs.append(dataclasses.replace(ue.cfg, slot=ue.cfg.slot))
        ul = SlotUlConfig(mu=mu, n_bwp_prb=bwp, pusch=tuple(cfgs), slot=slot)
        return ul, plans

    def handle_crc_indication(self, ue_idx: int, tb_ok: bool, harq_buffers=None):
        """crc.indication handler: advance or reset the UE's HARQ process."""
        ue = self.ues[ue_idx]
        if tb_ok:
            ue.harq.acked += 1
            ue.harq.round = 0
            ue.harq.buffers = None
        else:
            ue.harq.nacked += 1
            ue.harq.round += 1
            ue.harq.buffers = harq_buffers
            if ue.harq.round >= self.max_rounds:
                ue.harq.dtx += 1           # TB dropped (max rounds reached)
                ue.harq.round = 0
                ue.harq.buffers = None

    def stats(self) -> list[dict]:
        return [{
            "rnti": ue.cfg.rnti,
            "acked": ue.harq.acked,
            "nacked": ue.harq.nacked,
            "dropped": ue.harq.dtx,
        } for ue in self.ues]
