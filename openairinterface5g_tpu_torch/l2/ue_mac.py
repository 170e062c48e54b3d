"""UE MAC (TS 38.321): random access, BSR, HARQ — the
openair2/LAYER2/NR_MAC_UE analog (RA procedure in nr_ue_procedures.c).

State machine driven by the same FAPI-shaped messages the gNB MAC
(l2/mac.py) emits, so a UE instance can run against GnbMac in-process,
over the PNF/VNF split (fapi/transport.py), or against the PHY chain in
runtime/softmodem.py.

A copy of openairinterface5g_tpu/l2/ue_mac.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

HARQ_RV_SEQ = (0, 2, 3, 1)


@dataclasses.dataclass
class RaConfig:
    preamble_index: int = 17
    ra_rnti: int = 0x10B
    max_attempts: int = 8
    response_window_slots: int = 20
    backoff_slots: int = 10


@dataclasses.dataclass
class UeHarqProcess:
    active: bool = False
    round: int = 0
    payload: bytes = b""


class UeMac:
    """UE MAC entity: RA + UL scheduling-request/BSR + HARQ state."""

    def __init__(self, ra: RaConfig | None = None):
        self.ra = ra or RaConfig()
        self.state = "IDLE"      # IDLE->RA_PREAMBLE->RA_RESPONSE->RA_MSG3->CONNECTED
        self.c_rnti: Optional[int] = None
        self.tc_rnti: Optional[int] = None
        self.attempts = 0
        self.window_end = -1
        self.ul_buffer = 0       # pending UL bytes (drives BSR)
        self.harq = [UeHarqProcess() for _ in range(16)]
        self.msg3_payload = b""

    # --- random access (38.321 §5.1) -------------------------------------

    def start_ra(self, slot: int, msg3_payload: bytes = b"RRCSetupRequest"):
        """Kick off contention-based RA; returns the PRACH occasion request
        (preamble index) the PHY should transmit."""
        self.state = "RA_PREAMBLE"
        self.attempts += 1
        self.msg3_payload = msg3_payload
        self.window_end = slot + self.ra.response_window_slots
        return {"preamble_index": self.ra.preamble_index,
                "ra_rnti": self.ra.ra_rnti}

    def on_rar(self, slot: int, rar: dict):
        """Handle a RAR (msg2): {preamble_index, tc_rnti, ul_grant, ta}."""
        if self.state != "RA_PREAMBLE" or slot > self.window_end:
            return None
        if rar.get("preamble_index") != self.ra.preamble_index:
            return None
        self.tc_rnti = rar["tc_rnti"]
        self.state = "RA_MSG3"
        return {"rnti": self.tc_rnti, "payload": self.msg3_payload,
                "grant": rar.get("ul_grant")}

    def on_contention_resolution(self, rnti_echo: int, payload_echo: bytes):
        """Msg4: C-RNTI assignment if our msg3 is echoed (38.321 §5.1.5).

        The UE Contention Resolution Identity MAC CE carries the first
        48 bits of the msg3 CCCH SDU, so the match is on the echoed
        prefix (38.321 §6.1.3.3)."""
        if self.state != "RA_MSG3":
            return False
        n = min(len(payload_echo), len(self.msg3_payload))
        if n == 0 or payload_echo[:n] != self.msg3_payload[:n]:
            self.state = "IDLE"      # contention lost -> retry
            return False
        self.c_rnti = rnti_echo or self.tc_rnti
        self.state = "CONNECTED"
        self.attempts = 0
        return True

    def ra_timeout(self, slot: int) -> bool:
        """Window expiry check; True if another attempt should start."""
        if self.state == "RA_PREAMBLE" and slot > self.window_end:
            self.state = "IDLE"
            return self.attempts < self.ra.max_attempts
        return False

    # --- UL data path ------------------------------------------------------

    def push_ul_data(self, n_bytes: int):
        self.ul_buffer += n_bytes

    def bsr(self) -> int:
        """Buffer status index (38.321 Table 6.1.3.1-1 style log scale)."""
        if self.ul_buffer == 0:
            return 0
        return min(63, max(1, int(self.ul_buffer).bit_length() * 2))

    def on_ul_grant(self, tbs_bytes: int) -> dict:
        """Fill a grant: BSR MAC CE + data; shrinks the UL buffer."""
        take = min(self.ul_buffer, max(tbs_bytes - 2, 0))
        self.ul_buffer -= take
        return {"bsr": self.bsr(), "data_bytes": take}

    # --- DL HARQ -----------------------------------------------------------

    def on_dl_assignment(self, harq_id: int, ndi_toggled: bool, tb_ok: bool) -> str:
        """Track DL HARQ; returns 'ACK'/'NACK' feedback."""
        h = self.harq[harq_id]
        if ndi_toggled:
            h.active, h.round = True, 0
        else:
            h.round += 1
        if tb_ok:
            h.active = False
            return "ACK"
        return "NACK"
