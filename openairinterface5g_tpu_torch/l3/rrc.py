"""NR RRC (TS 38.331): message codecs + gNB/UE connection state machines.

Reference: openair2/RRC/NR (rrc_gnb.c `rrc_gnb_task` ITTI task, asn1c-
generated MESSAGES/).  Message schemas are declared with the UPER codec
in l3/per.py; the gNB side runs the RRC setup / security / reconfig
procedures over any transport that delivers (srb_id, pdu) — directly,
via the ITTI bus (utils/itti.py), or through F1AP RRC message transfer
(l3/f1ap.py).

A copy of openairinterface5g_tpu/l3/rrc.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from . import per

# --------------------------------------------------------------------------
# message schemas (38.331 §6.2.2, reduced field sets)
# --------------------------------------------------------------------------

ESTABLISHMENT_CAUSE = per.Enum((
    "emergency", "highPriorityAccess", "mt-Access", "mo-Signalling",
    "mo-Data", "mo-VoiceCall", "mo-VideoCall", "mo-SMS"))

RRC_SETUP_REQUEST = per.Seq((
    ("ue_identity", per.BitStr(39), False),       # random value / 5G-S-TMSI part
    ("establishment_cause", ESTABLISHMENT_CAUSE, False),
))

RRC_SETUP = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("radio_bearer_config", per.OctStr(), False),  # container (cell group etc.)
    ("master_cell_group", per.OctStr(), False),
))

RRC_SETUP_COMPLETE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("selected_plmn", per.Int(1, 12), False),
    ("dedicated_nas_message", per.OctStr(), False),
))

SECURITY_MODE_COMMAND = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("ciphering_algorithm", per.Enum(("nea0", "nea1", "nea2", "nea3")), False),
    ("integrity_algorithm", per.Enum(("nia0", "nia1", "nia2", "nia3")), True),
))

SECURITY_MODE_COMPLETE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
))

RRC_RECONFIGURATION = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("radio_bearer_config", per.OctStr(), True),
    ("secondary_cell_group", per.OctStr(), True),
    ("meas_config", per.OctStr(), True),
))

RRC_RECONFIGURATION_COMPLETE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
))

RRC_RELEASE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
))

MEASUREMENT_REPORT = per.Seq((
    ("meas_id", per.Int(1, 64), False),
    ("rsrp", per.Int(0, 127), False),             # 38.133 reported value
    ("rsrq", per.Int(0, 127), False),
))

SIB1 = per.Seq((
    ("plmn_mcc", per.Int(0, 999), False),
    ("plmn_mnc", per.Int(0, 999), False),
    ("tac", per.BitStr(24), False),
    ("cell_id", per.BitStr(36), False),
    ("q_rx_lev_min", per.Int(-70, -22), False),
    ("prach_config_index", per.Int(0, 255), False),
))

# UL-CCCH / UL-DCCH / DL-CCCH / DL-DCCH message wrappers: one CHOICE each
UL_MSG = per.Choice((
    ("rrcSetupRequest", RRC_SETUP_REQUEST),
    ("rrcSetupComplete", RRC_SETUP_COMPLETE),
    ("securityModeComplete", SECURITY_MODE_COMPLETE),
    ("rrcReconfigurationComplete", RRC_RECONFIGURATION_COMPLETE),
    ("measurementReport", MEASUREMENT_REPORT),
))

DL_MSG = per.Choice((
    ("rrcSetup", RRC_SETUP),
    ("securityModeCommand", SECURITY_MODE_COMMAND),
    ("rrcReconfiguration", RRC_RECONFIGURATION),
    ("rrcRelease", RRC_RELEASE),
    ("sib1", SIB1),
))


def encode_ul(name: str, msg: dict) -> bytes:
    return per.encode(UL_MSG, (name, msg))


def decode_ul(pdu: bytes):
    return per.decode(UL_MSG, pdu)


def encode_dl(name: str, msg: dict) -> bytes:
    return per.encode(DL_MSG, (name, msg))


def decode_dl(pdu: bytes):
    return per.decode(DL_MSG, pdu)


# --------------------------------------------------------------------------
# gNB RRC
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RrcUeContext:
    rnti: int
    state: str = "IDLE"        # IDLE -> SETUP_SENT -> CONNECTED -> SECURE -> RB_CONFIGURED
    transaction_id: int = 0
    ue_identity: int = 0
    security_on: bool = False
    drbs: list = dataclasses.field(default_factory=list)
    last_meas: Optional[dict] = None


class GnbRrc:
    """Per-cell RRC endpoint (rrc_gnb.c analog).

    `send_dl(rnti, srb_id, pdu)` is injected (ITTI / F1AP / direct);
    `nas_upstream(rnti, nas_pdu)` forwards NAS to the NGAP task.
    """

    def __init__(self, cell_id: int = 0,
                 send_dl: Callable[[int, int, bytes], None] | None = None,
                 nas_upstream: Callable[[int, bytes], None] | None = None):
        self.cell_id = cell_id
        self.send_dl = send_dl or (lambda *a: None)
        self.nas_upstream = nas_upstream or (lambda *a: None)
        self.ue: dict[int, RrcUeContext] = {}

    def sib1(self) -> bytes:
        return encode_dl("sib1", {
            "plmn_mcc": 1, "plmn_mnc": 1, "tac": 1,
            "cell_id": self.cell_id, "q_rx_lev_min": -60,
            "prach_config_index": 98})

    def handle_ul(self, rnti: int, pdu: bytes) -> None:
        name, msg = decode_ul(pdu)
        ctx = self.ue.setdefault(rnti, RrcUeContext(rnti=rnti))
        if name == "rrcSetupRequest":
            ctx.ue_identity = msg["ue_identity"]
            ctx.transaction_id = (ctx.transaction_id + 1) % 4
            ctx.state = "SETUP_SENT"
            self.send_dl(rnti, 0, encode_dl("rrcSetup", {
                "rrc_transaction_id": ctx.transaction_id,
                "radio_bearer_config": b"srb1",
                "master_cell_group": b"mcg0"}))
        elif name == "rrcSetupComplete":
            ctx.state = "CONNECTED"
            if msg["dedicated_nas_message"]:
                self.nas_upstream(rnti, msg["dedicated_nas_message"])
        elif name == "securityModeComplete":
            ctx.security_on = True
            ctx.state = "SECURE"
        elif name == "rrcReconfigurationComplete":
            ctx.state = "RB_CONFIGURED"
        elif name == "measurementReport":
            ctx.last_meas = msg

    def start_security(self, rnti: int) -> None:
        ctx = self.ue[rnti]
        ctx.transaction_id = (ctx.transaction_id + 1) % 4
        self.send_dl(rnti, 1, encode_dl("securityModeCommand", {
            "rrc_transaction_id": ctx.transaction_id,
            "ciphering_algorithm": "nea2",
            "integrity_algorithm": "nia2"}))

    def setup_drb(self, rnti: int, drb_id: int = 1) -> None:
        ctx = self.ue[rnti]
        ctx.transaction_id = (ctx.transaction_id + 1) % 4
        ctx.drbs.append(drb_id)
        self.send_dl(rnti, 1, encode_dl("rrcReconfiguration", {
            "rrc_transaction_id": ctx.transaction_id,
            "radio_bearer_config": bytes([drb_id]),
            "secondary_cell_group": None,
            "meas_config": None}))

    def release(self, rnti: int) -> None:
        ctx = self.ue.pop(rnti, None)
        if ctx is not None:
            self.send_dl(rnti, 1, encode_dl("rrcRelease", {
                "rrc_transaction_id": ctx.transaction_id}))


# --------------------------------------------------------------------------
# UE RRC
# --------------------------------------------------------------------------


class UeRrc:
    """UE-side mirror: drives the setup procedure and answers DL messages."""

    def __init__(self, send_ul: Callable[[int, bytes], None] | None = None):
        self.send_ul = send_ul or (lambda *a: None)
        self.state = "IDLE"
        self.security_on = False
        self.drbs: list[int] = []

    def connect(self, nas_pdu: bytes = b"") -> None:
        self._pending_nas = nas_pdu
        self.state = "SETUP_REQUESTED"
        self.send_ul(0, encode_ul("rrcSetupRequest", {
            "ue_identity": int.from_bytes(os.urandom(5), "big") & ((1 << 39) - 1),
            "establishment_cause": "mo-Data"}))

    def handle_dl(self, srb_id: int, pdu: bytes) -> None:
        name, msg = decode_dl(pdu)
        if name == "rrcSetup":
            self.state = "CONNECTED"
            self.send_ul(1, encode_ul("rrcSetupComplete", {
                "rrc_transaction_id": msg["rrc_transaction_id"],
                "selected_plmn": 1,
                "dedicated_nas_message": getattr(self, "_pending_nas", b"")}))
        elif name == "securityModeCommand":
            self.security_on = True
            self.send_ul(1, encode_ul("securityModeComplete", {
                "rrc_transaction_id": msg["rrc_transaction_id"]}))
        elif name == "rrcReconfiguration":
            if msg["radio_bearer_config"]:
                self.drbs.append(msg["radio_bearer_config"][0])
            self.state = "RB_CONFIGURED"
            self.send_ul(1, encode_ul("rrcReconfigurationComplete", {
                "rrc_transaction_id": msg["rrc_transaction_id"]}))
        elif name == "rrcRelease":
            self.state = "IDLE"
            self.security_on = False
            self.drbs.clear()
