"""NGAP (TS 38.413): gNB <-> AMF control procedures.

Reference: openair3/NGAP (ngap_gNB_task, asn1c codecs).  Procedures
covered: NGSetup, InitialUEMessage, Uplink/DownlinkNASTransport,
InitialContextSetup, PDUSessionResourceSetup, UEContextRelease —
the set exercised by the reference's 5g_rfsimulator CI flow.  Encoded
with the l3/per.py schema codec; transported over l3/sctp.py streams.

A copy of openairinterface5g_tpu/l3/ngap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

from typing import Callable

from . import per

PDU_SESSION_ITEM = per.Seq((
    ("pdu_session_id", per.Int(0, 255), False),
    ("teid", per.BitStr(32), False),
    ("transport_addr", per.BitStr(32), False),     # IPv4
    ("qfi", per.Int(0, 63), False),
))

MESSAGES = {
    "ngSetupRequest": per.Seq((
        ("global_gnb_id", per.BitStr(32), False),
        ("plmn_mcc", per.Int(0, 999), False),
        ("plmn_mnc", per.Int(0, 999), False),
        ("tac", per.BitStr(24), False),
    )),
    "ngSetupResponse": per.Seq((
        ("amf_name_len", per.Int(0, 150), False),
        ("relative_capacity", per.Int(0, 255), False),
    )),
    "initialUEMessage": per.Seq((
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
        ("nas_pdu", per.OctStr(), False),
        ("rrc_establishment_cause", per.Int(0, 15), False),
    )),
    "downlinkNASTransport": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
        ("nas_pdu", per.OctStr(), False),
    )),
    "uplinkNASTransport": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
        ("nas_pdu", per.OctStr(), False),
    )),
    "initialContextSetupRequest": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
        ("security_key", per.OctStr(), False),
        ("nas_pdu", per.OctStr(), True),
    )),
    "initialContextSetupResponse": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
    )),
    "pduSessionResourceSetupRequest": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
        ("sessions", per.SeqOf(PDU_SESSION_ITEM), False),
        ("nas_pdu", per.OctStr(), True),
    )),
    "pduSessionResourceSetupResponse": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
        ("sessions", per.SeqOf(PDU_SESSION_ITEM), False),
    )),
    "ueContextReleaseCommand": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
    )),
    "ueContextReleaseComplete": per.Seq((
        ("amf_ue_ngap_id", per.Int(0, (1 << 40) - 1), False),
        ("ran_ue_ngap_id", per.Int(0, (1 << 32) - 1), False),
    )),
}

_NAMES = tuple(sorted(MESSAGES))
WRAPPER = per.Choice(tuple((n, MESSAGES[n]) for n in _NAMES))


def encode(name: str, msg: dict) -> bytes:
    return per.encode(WRAPPER, (name, msg))


def decode(pdu: bytes):
    return per.decode(WRAPPER, pdu)


class GnbNgap:
    """gNB-side NGAP endpoint (`ngap_gNB_task` analog).

    send(pdu) transmits to the AMF (SCTP stream 0/1); callbacks deliver
    NAS downlink to RRC and context-setup events to the caller.
    """

    def __init__(self, gnb_id: int = 1,
                 send: Callable[[bytes], None] | None = None,
                 nas_downstream: Callable[[int, bytes], None] | None = None,
                 on_context_setup: Callable[[int, bytes], None] | None = None):
        self.gnb_id = gnb_id
        self.send = send or (lambda pdu: None)
        self.nas_downstream = nas_downstream or (lambda *a: None)
        self.on_context_setup = on_context_setup or (lambda *a: None)
        self.setup_done = False
        self.next_ran_id = 1
        self.ue: dict[int, dict] = {}          # ran_ue_ngap_id -> state

    def ng_setup(self):
        self.send(encode("ngSetupRequest", {
            "global_gnb_id": self.gnb_id, "plmn_mcc": 1, "plmn_mnc": 1,
            "tac": 1}))

    def initial_ue_message(self, rnti: int, nas_pdu: bytes) -> int:
        ran_id = self.next_ran_id
        self.next_ran_id += 1
        self.ue[ran_id] = {"rnti": rnti, "amf_id": None, "sessions": []}
        self.send(encode("initialUEMessage", {
            "ran_ue_ngap_id": ran_id, "nas_pdu": nas_pdu,
            "rrc_establishment_cause": 4}))
        return ran_id

    def uplink_nas(self, ran_id: int, nas_pdu: bytes):
        amf_id = self.ue[ran_id]["amf_id"] or 0
        self.send(encode("uplinkNASTransport", {
            "amf_ue_ngap_id": amf_id, "ran_ue_ngap_id": ran_id,
            "nas_pdu": nas_pdu}))

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "ngSetupResponse":
            self.setup_done = True
        elif name == "downlinkNASTransport":
            ran_id = msg["ran_ue_ngap_id"]
            self.ue[ran_id]["amf_id"] = msg["amf_ue_ngap_id"]
            self.nas_downstream(self.ue[ran_id]["rnti"], msg["nas_pdu"])
        elif name == "initialContextSetupRequest":
            ran_id = msg["ran_ue_ngap_id"]
            self.ue[ran_id]["amf_id"] = msg["amf_ue_ngap_id"]
            self.on_context_setup(self.ue[ran_id]["rnti"], msg["security_key"])
            if msg["nas_pdu"]:
                self.nas_downstream(self.ue[ran_id]["rnti"], msg["nas_pdu"])
            self.send(encode("initialContextSetupResponse", {
                "amf_ue_ngap_id": msg["amf_ue_ngap_id"],
                "ran_ue_ngap_id": ran_id}))
        elif name == "pduSessionResourceSetupRequest":
            ran_id = msg["ran_ue_ngap_id"]
            resp = []
            for s in msg["sessions"]:
                self.ue[ran_id]["sessions"].append(s)
                resp.append({"pdu_session_id": s["pdu_session_id"],
                             "teid": 0x1000 + s["pdu_session_id"],
                             "transport_addr": 0x0A000001,
                             "qfi": s["qfi"]})
            if msg["nas_pdu"]:
                self.nas_downstream(self.ue[ran_id]["rnti"], msg["nas_pdu"])
            self.send(encode("pduSessionResourceSetupResponse", {
                "amf_ue_ngap_id": msg["amf_ue_ngap_id"],
                "ran_ue_ngap_id": ran_id, "sessions": resp}))
        elif name == "ueContextReleaseCommand":
            ran_id = msg["ran_ue_ngap_id"]
            self.ue.pop(ran_id, None)
            self.send(encode("ueContextReleaseComplete", {
                "amf_ue_ngap_id": msg["amf_ue_ngap_id"],
                "ran_ue_ngap_id": ran_id}))


class AmfNgapStub:
    """Tiny AMF NGAP side for closed-loop tests: pairs with l3/nas.AmfStub."""

    def __init__(self, send: Callable[[bytes], None] | None = None,
                 nas_handler=None):
        self.send = send or (lambda pdu: None)
        self.nas = nas_handler
        self.next_amf_id = 100
        self.ue: dict[int, int] = {}            # ran_id -> amf_id
        self.context_setup_sent: set[int] = set()

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "ngSetupRequest":
            self.send(encode("ngSetupResponse", {
                "amf_name_len": 3, "relative_capacity": 50}))
        elif name in ("initialUEMessage", "uplinkNASTransport"):
            ran_id = msg["ran_ue_ngap_id"]
            amf_id = self.ue.setdefault(ran_id, self.next_amf_id + ran_id)
            replies = self.nas.handle(msg["nas_pdu"]) if self.nas else []
            for r in replies:
                if (self.nas and self.nas.state == "REGISTERED"
                        and ran_id not in self.context_setup_sent):
                    self.context_setup_sent.add(ran_id)
                    self.send(encode("initialContextSetupRequest", {
                        "amf_ue_ngap_id": amf_id, "ran_ue_ngap_id": ran_id,
                        "security_key": b"\x11" * 32, "nas_pdu": r}))
                elif self.nas and self.nas.state == "SESSION":
                    self.send(encode("pduSessionResourceSetupRequest", {
                        "amf_ue_ngap_id": amf_id, "ran_ue_ngap_id": ran_id,
                        "sessions": [{"pdu_session_id": 1, "teid": 0x2000,
                                      "transport_addr": 0x0A000002, "qfi": 9}],
                        "nas_pdu": r}))
                else:
                    self.send(encode("downlinkNASTransport", {
                        "amf_ue_ngap_id": amf_id, "ran_ue_ngap_id": ran_id,
                        "nas_pdu": r}))
