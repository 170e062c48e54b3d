"""gNB MAC scheduler: proportional-fair DL/UL scheduling + HARQ + RA.

Compact functional analog of openair2/LAYER2/NR_MAC_gNB:
  - gNB_dlsch_ulsch_scheduler (gNB_scheduler.c:191) per-slot entry
  - PF time/frequency scheduling (gNB_scheduler_dlsch.c pf_dl /
    gNB_scheduler_ulsch.c pf_ul): metric = achievable rate / average
    throughput, PRB allocation by metric order
  - CQI -> MCS mapping, link adaptation with BLER target stepping
  - HARQ process pool per UE (8 processes, rv sequence
    nr_rv_round_map = {0,2,3,1}, gNB_scheduler.c:56)
  - RA procedure skeleton: msg2 scheduling after RACH.indication
    (nr_schedule_RA analog)

The scheduler emits FAPI-shaped requests (fapi/messages.py), so it can
drive the PHY directly (models/gnb.py) or across the PNF/VNF UDP split
(fapi/transport.py).

A copy of openairinterface5g_tpu/l2/mac.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..fapi import messages as fapi
from ..transport import mcs_to_qm_rate

HARQ_RV_SEQ = (0, 2, 3, 1)
N_HARQ = 8

# CQI index (4-bit, table 5.2.2.1-2 38.214) -> MCS (table 1) working points
_CQI_TO_MCS = [0, 0, 0, 2, 4, 6, 8, 11, 13, 15, 18, 20, 22, 24, 26, 28]


@dataclasses.dataclass
class HarqProcess:
    active: bool = False
    round: int = 0
    tbs: int = 0
    mcs: int = 0
    prbs: tuple = (0, 0)          # (start, size)
    payload: bytes = b""

    @property
    def rv(self) -> int:
        return HARQ_RV_SEQ[self.round % 4]


@dataclasses.dataclass
class UeMacState:
    rnti: int
    cqi: int = 9
    ul_cqi: int | None = None     # SRS-derived UL CQI (on_srs); falls
                                  # back to the DL CQI when never sounded
    ul_pmi: int = 0               # SRS-derived UL codebook index
    bwps: tuple = ((0, None),)    # ((prb_start, n_prb|None=full), ...)
                                  # 38.331 BWP-Downlink/-Uplink configs
    active_bwp: int = 0           # bandwidth-part indicator (DCI field)
    # connected-mode DRX (38.321 §5.7); cycle=0 disables
    drx_cycle: int = 0            # slots per DRX cycle
    drx_on_duration: int = 0      # active slots at each cycle start
    drx_inactivity: int = 0       # slots of activity extension after a grant
    drx_inactive_until: int = -1  # slot until which the inactivity timer runs
    dl_buffer: int = 0            # bytes queued for DL
    ul_buffer: int = 0            # bytes reported via BSR
    avg_thr_dl: float = 1.0       # PF average throughput (bytes/slot, EWMA)
    avg_thr_ul: float = 1.0
    dl_harq: list = dataclasses.field(
        default_factory=lambda: [HarqProcess() for _ in range(N_HARQ)])
    ul_harq: list = dataclasses.field(
        default_factory=lambda: [HarqProcess() for _ in range(N_HARQ)])
    bler_ewma: float = 0.0
    mcs_offset: int = 0           # link adaptation backoff

    def free_harq(self, pool) -> Optional[int]:
        for i, h in enumerate(pool):
            if not h.active:
                return i
        return None


def cqi_to_mcs(cqi: int, offset: int = 0) -> int:
    mcs = _CQI_TO_MCS[max(0, min(15, cqi))] + offset
    return max(0, min(28, mcs))


def tbs_bytes(mcs: int, n_prb: int, n_symbols: int = 13,
              n_layers: int = 1) -> int:
    """Approximate TBS in bytes for scheduling decisions (the MAC's
    nr_compute_tbs wrapper role — the PHY recomputes the exact TBS)."""
    from ..transport import compute_tbs
    qm, r = mcs_to_qm_rate(mcs, 1)
    return compute_tbs(qm, r * 1024, n_prb, n_symbols, 12, 0, n_layers) // 8


@dataclasses.dataclass
class SchedulerConfig:
    n_bwp_prb: int = 106
    mu: int = 1
    n_dl_symbols: int = 13
    n_ul_symbols: int = 13
    pf_alpha: float = 0.01        # EWMA forgetting factor
    target_bler: float = 0.1
    min_prb: int = 4              # smallest allocation
    # broadcast scheduling (schedule_nr_mib / SIB1 path, gNB_scheduler.c:252)
    sib1_period_frames: int = 16  # 160 ms SIB1 periodicity
    sib1_payload: bytes = b""     # encoded SIB1 (empty = don't schedule)
    sib1_prbs: int = 24
    # paging (38.304 §7.1): PF = SFN mod T == (T/N)*(ue_id mod N)
    drx_cycle_frames: int = 32    # T
    paging_n: int = 4             # N paging frames per cycle
    tdd: object = None            # runtime.tdd.TddConfig | None


class MacScheduler:
    """PF MAC scheduler over a fixed UE set (gNB_dlsch_ulsch_scheduler)."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.ues: dict[int, UeMacState] = {}
        self.ra_queue: list[tuple[int, int]] = []   # (preamble, ta)
        self.paging_queue: list[tuple[int, bytes]] = []

    def add_ue(self, rnti: int, **kw) -> UeMacState:
        ue = UeMacState(rnti=rnti, **kw)
        self.ues[rnti] = ue
        return ue

    # ---- indication handlers (NR_UL_indication analog) ----

    def _harq_feedback(self, ue: UeMacState, harq_id: int, ok: bool,
                       ul: bool):
        pool = ue.ul_harq if ul else ue.dl_harq
        h = pool[harq_id]
        ue.bler_ewma = (1 - 0.05) * ue.bler_ewma + 0.05 * (0.0 if ok else 1.0)
        if ok:
            if ul and h.active:
                ue.ul_buffer = max(0, ue.ul_buffer - h.tbs)
            h.active = False
            h.round = 0
        else:
            h.round += 1
            if h.round >= 4:       # max rounds: drop (RLC retransmits)
                h.active = False
                h.round = 0
        # link adaptation: back off MCS if BLER above target
        if ue.bler_ewma > self.cfg.target_bler * 1.5:
            ue.mcs_offset = max(-6, ue.mcs_offset - 1)
            ue.bler_ewma = self.cfg.target_bler
        elif ue.bler_ewma < self.cfg.target_bler * 0.3:
            ue.mcs_offset = min(2, ue.mcs_offset + 1)
            ue.bler_ewma = self.cfg.target_bler * 0.75

    def on_crc(self, ind: fapi.CrcIndication, ul: bool = True):
        for handle, rnti, harq_id, ok in ind.crcs:
            ue = self.ues.get(rnti)
            if ue is not None:
                self._harq_feedback(ue, harq_id, ok, ul)

    def on_dl_ack(self, rnti: int, harq_id: int, ack: bool):
        """DL HARQ feedback from PUCCH HARQ-ACK (handle_nr_uci analog)."""
        ue = self.ues.get(rnti)
        if ue is not None:
            self._harq_feedback(ue, harq_id, ack, ul=False)

    def on_uci_cqi(self, rnti: int, cqi: int):
        if rnti in self.ues:
            self.ues[rnti].cqi = cqi

    def on_srs(self, rnti: int, report: dict):
        """SRS indication consumer (handle_nr_srs analog): the sounded
        UL channel drives the UL MCS independently of the DL CQI, and a
        2-port report carries the UL codebook PMI."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        ue.ul_cqi = int(report["ul_cqi"])
        if "pmi" in report:
            ue.ul_pmi = int(report["pmi"])

    def on_rach(self, ind: fapi.RachIndication):
        for idx, ta, _pw in ind.preambles:
            self.ra_queue.append((idx, ta))

    def on_bsr(self, rnti: int, n_bytes: int):
        if rnti in self.ues:
            self.ues[rnti].ul_buffer = n_bytes

    def drx_active(self, ue: UeMacState, slot_abs: int) -> bool:
        """True when the UE is in DRX Active Time (onDurationTimer or
        drx-InactivityTimer running, 38.321 §5.7)."""
        if ue.drx_cycle <= 0:
            return True
        if slot_abs < ue.drx_inactive_until:
            return True
        return (slot_abs % ue.drx_cycle) < ue.drx_on_duration

    def switch_bwp(self, rnti: int, bwp_id: int):
        """Activate a configured BWP (the DCI bandwidth-part-indicator
        switch, 38.213 §12): subsequent allocations land inside it and
        the scheduler's grants carry the new indicator."""
        ue = self.ues[rnti]
        assert 0 <= bwp_id < len(ue.bwps), bwp_id
        ue.active_bwp = bwp_id

    def _bwp_window(self, ue: UeMacState) -> tuple:
        p0, sz = ue.bwps[ue.active_bwp]
        return p0, (self.cfg.n_bwp_prb - p0 if sz is None else sz)

    # ---- per-slot scheduling ----

    def _pf_allocate(self, cands: list[UeMacState], dl: bool):
        """PF metric ordering + greedy PRB split (pf_dl/pf_ul analog).

        Returns [(ue, prb_start, prb_size, mcs)].
        """
        cfg = self.cfg
        scored = []
        for ue in cands:
            cqi = ue.cqi if (dl or ue.ul_cqi is None) else ue.ul_cqi
            mcs = cqi_to_mcs(cqi, ue.mcs_offset)
            rate = tbs_bytes(mcs, cfg.n_bwp_prb,
                             cfg.n_dl_symbols if dl else cfg.n_ul_symbols)
            avg = ue.avg_thr_dl if dl else ue.avg_thr_ul
            scored.append((rate / max(avg, 1e-6), ue, mcs))
        scored.sort(key=lambda t: -t[0])
        # greedy: split PRBs proportionally to remaining buffer, metric
        # order, each UE constrained to its ACTIVE BWP window
        out = []
        prb_next = 0
        for rank, (_, ue, mcs) in enumerate(scored):
            b0, bsz = self._bwp_window(ue)
            start = max(prb_next, b0)
            avail = b0 + bsz - start
            if avail <= 0:
                continue
            buf = ue.dl_buffer if dl else ue.ul_buffer
            per_prb = max(1, tbs_bytes(mcs, cfg.n_bwp_prb) // cfg.n_bwp_prb)
            want = max(cfg.min_prb, -(-buf // per_prb))
            # leave min_prb headroom for each remaining candidate so one
            # full-buffer UE can't starve the slot (pf_dl's remainUEs logic)
            reserve = cfg.min_prb * (len(scored) - rank - 1)
            size = min(want, max(cfg.min_prb, avail - reserve), avail)
            if size <= 0:
                continue
            out.append((ue, start, size, mcs))
            prb_next = start + size
        return out

    SI_RNTI = 0xFFFF
    P_RNTI = 0xFFFE

    def page_ue(self, ue_id: int, record: bytes = b""):
        """Queue a paging record (NGAP Paging -> MAC, 38.304 §7.1)."""
        self.paging_queue.append((ue_id, record or ue_id.to_bytes(4, "big")))

    def _broadcast_pdus(self, sfn: int, slot: int, dl_pdus, payloads):
        """SIB1 + paging occasions for this slot (gNB_scheduler.c:252
        schedule_nr_mib / gNB_scheduler_dlsch SIB1 path analog)."""
        cfg = self.cfg
        if (cfg.sib1_payload and slot == 0
                and sfn % cfg.sib1_period_frames == 0):
            dl_pdus.append(fapi.PdschPdu(
                rnti=self.SI_RNTI, pdu_index=len(dl_pdus), mcs=2,
                rb_start=0, rb_size=cfg.sib1_prbs,
                nr_of_symbols=cfg.n_dl_symbols))
            payloads.append(cfg.sib1_payload)
        if self.paging_queue:
            T, N = cfg.drx_cycle_frames, cfg.paging_n
            due = [(uid, rec) for uid, rec in self.paging_queue
                   if sfn % T == (T // N) * (uid % N) and slot == 1]
            if due:
                rec = b"".join(r for _, r in due)
                dl_pdus.append(fapi.PdschPdu(
                    rnti=self.P_RNTI, pdu_index=len(dl_pdus), mcs=2,
                    rb_start=0, rb_size=cfg.sib1_prbs,
                    nr_of_symbols=cfg.n_dl_symbols))
                payloads.append(rec)
                self.paging_queue = [q for q in self.paging_queue
                                     if q not in due]

    def schedule_slot(self, sfn: int, slot: int):
        """-> (DlTtiRequest, UlTtiRequest, TxDataRequest) for this slot."""
        cfg = self.cfg
        a = cfg.pf_alpha

        # TDD gating: no DL PDUs in U slots, no UL PDUs in D slots
        slot_type = cfg.tdd.slot_type(slot) if cfg.tdd is not None else None
        dl_ok = slot_type in (None, "D", "S")
        ul_ok = slot_type in (None, "U", "S")

        slot_abs = sfn * (10 << cfg.mu) + slot
        dl_pdus, payloads = [], []
        if dl_ok:
            self._broadcast_pdus(sfn, slot, dl_pdus, payloads)
            # DL retransmissions first (existing active HARQ with round>0)
            for ue in self.ues.values():
                for hid, h in enumerate(ue.dl_harq):
                    if h.active and h.round > 0:
                        dl_pdus.append(fapi.PdschPdu(
                            rnti=ue.rnti, pdu_index=len(dl_pdus), mcs=h.mcs,
                            rb_start=h.prbs[0], rb_size=h.prbs[1],
                            nr_of_symbols=cfg.n_dl_symbols, rv=h.rv,
                            harq_process_id=hid, new_data=0))
                        payloads.append(h.payload)
            cands = [u for u in self.ues.values()
                     if u.dl_buffer > 0 and u.free_harq(u.dl_harq) is not None
                     and self.drx_active(u, slot_abs)]
            for ue, p0, sz, mcs in self._pf_allocate(cands, dl=True):
                ue.drx_inactive_until = slot_abs + ue.drx_inactivity
                hid = ue.free_harq(ue.dl_harq)
                tbs = tbs_bytes(mcs, sz, cfg.n_dl_symbols)
                pay = bytes(min(tbs, ue.dl_buffer))
                h = ue.dl_harq[hid]
                h.active, h.round, h.tbs, h.mcs, h.prbs, h.payload = \
                    True, 0, tbs, mcs, (p0, sz), pay
                ue.dl_buffer = max(0, ue.dl_buffer - tbs)
                ue.avg_thr_dl = (1 - a) * ue.avg_thr_dl + a * tbs
                dl_pdus.append(fapi.PdschPdu(
                    rnti=ue.rnti, pdu_index=len(dl_pdus), mcs=mcs, rb_start=p0,
                    rb_size=sz, nr_of_symbols=cfg.n_dl_symbols, rv=0,
                    harq_process_id=hid, new_data=1))
                payloads.append(pay)

        ul_pdus = []
        if ul_ok:
            for ue in self.ues.values():
                for hid, h in enumerate(ue.ul_harq):
                    if h.active and h.round > 0:
                        ul_pdus.append(fapi.PuschPduMsg(
                            rnti=ue.rnti, handle=len(ul_pdus), mcs=h.mcs,
                            rb_start=h.prbs[0], rb_size=h.prbs[1], rv=h.rv,
                            harq_process_id=hid, new_data=0,
                            nr_of_symbols=cfg.n_ul_symbols))
            cands = [u for u in self.ues.values()
                     if u.ul_buffer > 0 and u.free_harq(u.ul_harq) is not None
                     and self.drx_active(u, slot_abs)]
            for ue, p0, sz, mcs in self._pf_allocate(cands, dl=False):
                ue.drx_inactive_until = slot_abs + ue.drx_inactivity
                hid = ue.free_harq(ue.ul_harq)
                tbs = tbs_bytes(mcs, sz, cfg.n_ul_symbols)
                h = ue.ul_harq[hid]
                h.active, h.round, h.tbs, h.mcs, h.prbs = \
                    True, 0, tbs, mcs, (p0, sz)
                ue.avg_thr_ul = (1 - a) * ue.avg_thr_ul + a * tbs
                ul_pdus.append(fapi.PuschPduMsg(
                    rnti=ue.rnti, handle=len(ul_pdus), mcs=mcs, rb_start=p0,
                    rb_size=sz, rv=0, harq_process_id=hid, new_data=1,
                    nr_of_symbols=cfg.n_ul_symbols))

        dl = fapi.DlTtiRequest(sfn=sfn, slot=slot, pdsch=tuple(dl_pdus))
        ul = fapi.UlTtiRequest(sfn=sfn, slot=slot, pusch=tuple(ul_pdus))
        txd = fapi.TxDataRequest(sfn=sfn, slot=slot, payloads=tuple(payloads))
        return dl, ul, txd
