"""LTE RRC (TS 36.331): message codecs + eNB/UE connection state machines.

Reference: openair2/RRC/LTE (rrc_eNB.c / asn1c-generated MESSAGES).  The
round-4 build had the full LTE PHY but nothing above it; this is the
minimal connected stack: RRCConnectionRequest -> Setup -> SetupComplete
-> SecurityModeCommand/Complete -> ConnectionReconfiguration (DRB add)
-> Complete, plus ConnectionRelease.  Schemas use the same UPER-style
codec as the NR stack (l3/per.py).

A copy of openairinterface5g_tpu/lte/rrc.py on the port's own l3/per.py;
tests/test_torch_lte_stack.py holds the PDUs equal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..l3 import per

ESTABLISHMENT_CAUSE = per.Enum((
    "emergency", "highPriorityAccess", "mt-Access", "mo-Signalling",
    "mo-Data", "delayTolerantAccess-v1020", "mo-VoiceCall-v1280", "spare1"))

RRC_CONNECTION_REQUEST = per.Seq((
    ("ue_identity", per.BitStr(40), False),        # S-TMSI / random value
    ("establishment_cause", ESTABLISHMENT_CAUSE, False),
))

RRC_CONNECTION_SETUP = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("radio_resource_config", per.OctStr(), False),  # SRB1 + mac/phy config
))

RRC_CONNECTION_SETUP_COMPLETE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("selected_plmn", per.Int(1, 6), False),
    ("dedicated_info_nas", per.OctStr(), False),
))

SECURITY_MODE_COMMAND = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("ciphering_algorithm", per.Enum(("eea0", "eea1", "eea2", "eea3")), False),
    ("integrity_algorithm", per.Enum(("eia0", "eia1", "eia2", "eia3")), False),
))

SECURITY_MODE_COMPLETE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
))

RRC_CONNECTION_RECONFIGURATION = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("drb_to_add", per.Int(1, 32), True),          # DRB identity
    ("eps_bearer_id", per.Int(0, 15), True),
    ("meas_config", per.OctStr(), True),
))

RRC_CONNECTION_RECONFIGURATION_COMPLETE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
))

RRC_CONNECTION_RELEASE = per.Seq((
    ("rrc_transaction_id", per.Int(0, 3), False),
    ("release_cause", per.Enum(("loadBalancing", "other", "cs-Fallback",
                                "rrc-Suspend")), False),
))

# CCCH/DCCH message CHOICE (36.331 §6.2.1 class-1/2 message sets)
MSG = per.Choice((
    ("rrcConnectionRequest", RRC_CONNECTION_REQUEST),
    ("rrcConnectionSetup", RRC_CONNECTION_SETUP),
    ("rrcConnectionSetupComplete", RRC_CONNECTION_SETUP_COMPLETE),
    ("securityModeCommand", SECURITY_MODE_COMMAND),
    ("securityModeComplete", SECURITY_MODE_COMPLETE),
    ("rrcConnectionReconfiguration", RRC_CONNECTION_RECONFIGURATION),
    ("rrcConnectionReconfigurationComplete",
     RRC_CONNECTION_RECONFIGURATION_COMPLETE),
    ("rrcConnectionRelease", RRC_CONNECTION_RELEASE),
))


def encode_msg(name: str, fields: dict) -> bytes:
    return per.encode(MSG, (name, fields))


def decode_msg(pdu: bytes) -> tuple[str, dict]:
    return per.decode(MSG, pdu)


@dataclasses.dataclass
class EnbUeCtx:
    c_rnti: int
    state: str = "IDLE"      # IDLE -> SETUP_SENT -> CONNECTED -> SECURE
                             # -> RECONFIGURING -> ACTIVE
    drbs: tuple = ()
    transaction: int = 0


class EnbRrc:
    """eNB-side RRC (rrc_eNB.c connection management analog).

    send(rnti, pdu_bytes) is the SRB transport (any path that delivers
    bytes — the lte softmodem loop carries them in PDSCH TBs)."""

    def __init__(self, send: Callable[[int, bytes], None]):
        self.send = send
        self.ues: dict[int, EnbUeCtx] = {}

    def on_ccch(self, c_rnti: int, pdu: bytes):
        t, f = decode_msg(pdu)
        assert t == "rrcConnectionRequest", "SRB0 carries the request"
        ctx = self.ues.setdefault(c_rnti, EnbUeCtx(c_rnti=c_rnti))
        ctx.state = "SETUP_SENT"
        self.send(c_rnti, encode_msg("rrcConnectionSetup", {
            "rrc_transaction_id": ctx.transaction,
            "radio_resource_config": b"srb1+mac+phy"}))

    def on_dcch(self, c_rnti: int, pdu: bytes):
        ctx = self.ues[c_rnti]
        t, f = decode_msg(pdu)
        if t == "rrcConnectionSetupComplete" and ctx.state == "SETUP_SENT":
            ctx.state = "CONNECTED"
            ctx.transaction += 1
            self.send(c_rnti, encode_msg("securityModeCommand", {
                "rrc_transaction_id": ctx.transaction,
                "ciphering_algorithm": "eea2",
                "integrity_algorithm": "eia2"}))
        elif t == "securityModeComplete" and ctx.state == "CONNECTED":
            ctx.state = "RECONFIGURING"
            ctx.transaction += 1
            self.send(c_rnti, encode_msg("rrcConnectionReconfiguration", {
                "rrc_transaction_id": ctx.transaction,
                "drb_to_add": 1, "eps_bearer_id": 5}))
        elif (t == "rrcConnectionReconfigurationComplete"
              and ctx.state == "RECONFIGURING"):
            ctx.drbs = ctx.drbs + (1,)
            ctx.state = "ACTIVE"

    def release(self, c_rnti: int, cause: str = "other"):
        ctx = self.ues[c_rnti]
        ctx.transaction += 1
        self.send(c_rnti, encode_msg("rrcConnectionRelease", {
            "rrc_transaction_id": ctx.transaction, "release_cause": cause}))
        ctx.state = "IDLE"


class LteUeRrc:
    """UE-side RRC state machine (openair2/RRC/LTE UE analog)."""

    def __init__(self, send: Callable[[bytes], None], ue_id: int = 0x5A5):
        self.send = send
        self.ue_id = ue_id
        self.state = "IDLE"
        self.drbs: tuple = ()

    def connect(self):
        self.state = "REQUESTING"
        self.send(encode_msg("rrcConnectionRequest", {
            "ue_identity": self.ue_id,
            "establishment_cause": "mo-Data"}))

    def on_dl(self, pdu: bytes):
        t, f = decode_msg(pdu)
        if t == "rrcConnectionSetup" and self.state == "REQUESTING":
            self.state = "CONNECTED"
            self.send(encode_msg("rrcConnectionSetupComplete", {
                "rrc_transaction_id": f["rrc_transaction_id"],
                "selected_plmn": 1,
                "dedicated_info_nas": b"ATTACH_REQ"}))
        elif t == "securityModeCommand":
            self.state = "SECURE"
            self.send(encode_msg("securityModeComplete", {
                "rrc_transaction_id": f["rrc_transaction_id"]}))
        elif t == "rrcConnectionReconfiguration":
            self.drbs = self.drbs + (f.get("drb_to_add") or 1,)
            self.state = "ACTIVE"
            self.send(encode_msg("rrcConnectionReconfigurationComplete", {
                "rrc_transaction_id": f["rrc_transaction_id"]}))
        elif t == "rrcConnectionRelease":
            self.state = "IDLE"
