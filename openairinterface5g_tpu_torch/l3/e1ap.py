"""E1AP (TS 38.463): CU-CP <-> CU-UP split — openair2/E1AP analog.

Procedures: GNB-CU-UP E1 Setup and Bearer Context Setup/Release — the
set the reference's nr-cuup executable drives.  The CU-UP pairs a
bearer context with PDCP entities (l2/pdcp.py) and a GTP-U endpoint
(l3/gtpu.py).

A copy of openairinterface5g_tpu/l3/e1ap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

from typing import Callable

from . import per

MESSAGES = {
    "e1SetupRequest": per.Seq((
        ("gnb_cu_up_id", per.Int(0, (1 << 36) - 1), False),
    )),
    "e1SetupResponse": per.Seq((
        ("transaction_id", per.Int(0, 255), False),
    )),
    "bearerContextSetupRequest": per.Seq((
        ("cu_cp_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("pdu_session_id", per.Int(0, 255), False),
        ("drb_id", per.Int(1, 32), False),
        ("ul_teid", per.BitStr(32), False),       # NG-U uplink tunnel (UPF)
    )),
    "bearerContextSetupResponse": per.Seq((
        ("cu_cp_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("cu_up_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("dl_teid", per.BitStr(32), False),       # NG-U downlink (CU-UP)
        ("f1u_teid", per.BitStr(32), False),      # F1-U toward the DU
    )),
    "bearerContextReleaseCommand": per.Seq((
        ("cu_cp_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("cu_up_ue_id", per.Int(0, (1 << 32) - 1), False),
    )),
    "bearerContextReleaseComplete": per.Seq((
        ("cu_cp_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("cu_up_ue_id", per.Int(0, (1 << 32) - 1), False),
    )),
}

WRAPPER = per.Choice(tuple((n, MESSAGES[n]) for n in sorted(MESSAGES)))


def encode(name: str, msg: dict) -> bytes:
    return per.encode(WRAPPER, (name, msg))


def decode(pdu: bytes):
    return per.decode(WRAPPER, pdu)


class CuUpE1ap:
    """CU-UP endpoint (nr-cuup analog): owns bearer contexts."""

    def __init__(self, cu_up_id: int = 1,
                 send: Callable[[bytes], None] | None = None):
        self.cu_up_id = cu_up_id
        self.send = send or (lambda pdu: None)
        self.next_ue_id = 1
        self.bearers: dict[int, dict] = {}       # cu_up_ue_id -> context

    def e1_setup(self):
        self.send(encode("e1SetupRequest", {"gnb_cu_up_id": self.cu_up_id}))

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "bearerContextSetupRequest":
            ue_id = self.next_ue_id
            self.next_ue_id += 1
            self.bearers[ue_id] = {
                "cu_cp_ue_id": msg["cu_cp_ue_id"],
                "pdu_session_id": msg["pdu_session_id"],
                "drb_id": msg["drb_id"], "ul_teid": msg["ul_teid"],
                "dl_teid": 0x5000 + ue_id, "f1u_teid": 0x6000 + ue_id}
            self.send(encode("bearerContextSetupResponse", {
                "cu_cp_ue_id": msg["cu_cp_ue_id"], "cu_up_ue_id": ue_id,
                "dl_teid": 0x5000 + ue_id, "f1u_teid": 0x6000 + ue_id}))
        elif name == "bearerContextReleaseCommand":
            self.bearers.pop(msg["cu_up_ue_id"], None)
            self.send(encode("bearerContextReleaseComplete", {
                "cu_cp_ue_id": msg["cu_cp_ue_id"],
                "cu_up_ue_id": msg["cu_up_ue_id"]}))


class CuCpE1ap:
    """CU-CP side driver."""

    def __init__(self, send: Callable[[bytes], None] | None = None):
        self.send = send or (lambda pdu: None)
        self.setup_done = False
        self.contexts: dict[int, dict] = {}      # cu_cp_ue_id -> tunnel info

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "e1SetupRequest":
            self.send(encode("e1SetupResponse", {"transaction_id": 0}))
            self.setup_done = True
        elif name == "bearerContextSetupResponse":
            self.contexts[msg["cu_cp_ue_id"]] = {
                "cu_up_ue_id": msg["cu_up_ue_id"],
                "dl_teid": msg["dl_teid"], "f1u_teid": msg["f1u_teid"]}

    def setup_bearer(self, cu_cp_ue_id: int, pdu_session_id: int,
                     drb_id: int, ul_teid: int):
        self.send(encode("bearerContextSetupRequest", {
            "cu_cp_ue_id": cu_cp_ue_id, "pdu_session_id": pdu_session_id,
            "drb_id": drb_id, "ul_teid": ul_teid}))
