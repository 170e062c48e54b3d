"""F1AP (TS 38.473): CU <-> DU split — openair2/F1AP analog.

Procedures: F1Setup, UE Context Setup/Release, Initial UL RRC Message
Transfer, DL/UL RRC Message Transfer.  With l3/rrc.py on the CU side
and the MAC/PHY stack on the DU side this realizes the C9 split the
reference implements over SCTP (here l3/sctp.py framing).

A copy of openairinterface5g_tpu/l3/f1ap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

from typing import Callable

from . import per

MESSAGES = {
    "f1SetupRequest": per.Seq((
        ("gnb_du_id", per.Int(0, (1 << 36) - 1), False),
        ("cell_id", per.BitStr(36), False),
        ("plmn_mcc", per.Int(0, 999), False),
        ("plmn_mnc", per.Int(0, 999), False),
    )),
    "f1SetupResponse": per.Seq((
        ("transaction_id", per.Int(0, 255), False),
        ("cells_to_activate", per.SeqOf(per.BitStr(36)), False),
    )),
    "initialULRRCMessageTransfer": per.Seq((
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("c_rnti", per.Int(0, 65535), False),
        ("rrc_container", per.OctStr(), False),
    )),
    "dlRRCMessageTransfer": per.Seq((
        ("gnb_cu_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("srb_id", per.Int(0, 3), False),
        ("rrc_container", per.OctStr(), False),
    )),
    "ulRRCMessageTransfer": per.Seq((
        ("gnb_cu_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("srb_id", per.Int(0, 3), False),
        ("rrc_container", per.OctStr(), False),
    )),
    "ueContextSetupRequest": per.Seq((
        ("gnb_cu_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("drb_id", per.Int(1, 32), False),
        ("rrc_container", per.OctStr(), True),
    )),
    "ueContextSetupResponse": per.Seq((
        ("gnb_cu_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("du_teid", per.BitStr(32), False),
    )),
    "ueContextReleaseCommand": per.Seq((
        ("gnb_cu_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
    )),
    "ueContextReleaseComplete": per.Seq((
        ("gnb_cu_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("gnb_du_ue_id", per.Int(0, (1 << 32) - 1), False),
    )),
}

WRAPPER = per.Choice(tuple((n, MESSAGES[n]) for n in sorted(MESSAGES)))


def encode(name: str, msg: dict) -> bytes:
    return per.encode(WRAPPER, (name, msg))


def decode(pdu: bytes):
    return per.decode(WRAPPER, pdu)


class CuF1ap:
    """CU endpoint: bridges F1AP RRC transfer to a GnbRrc instance."""

    def __init__(self, rrc, send: Callable[[bytes], None] | None = None):
        self.rrc = rrc
        self.send = send or (lambda pdu: None)
        self.setup_done = False
        self.next_cu_ue_id = 1
        self.by_du_id: dict[int, dict] = {}
        # plug RRC's DL path back through F1AP
        rrc.send_dl = self._rrc_dl

    def _rrc_dl(self, rnti: int, srb_id: int, pdu: bytes):
        for du_id, st in self.by_du_id.items():
            if st["rnti"] == rnti:
                self.send(encode("dlRRCMessageTransfer", {
                    "gnb_cu_ue_id": st["cu_id"], "gnb_du_ue_id": du_id,
                    "srb_id": srb_id, "rrc_container": pdu}))
                return

    def setup_drb(self, rnti: int, drb_id: int = 1):
        for du_id, st in self.by_du_id.items():
            if st["rnti"] == rnti:
                self.send(encode("ueContextSetupRequest", {
                    "gnb_cu_ue_id": st["cu_id"], "gnb_du_ue_id": du_id,
                    "drb_id": drb_id, "rrc_container": None}))
                self.rrc.setup_drb(rnti, drb_id)
                return

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "f1SetupRequest":
            self.send(encode("f1SetupResponse", {
                "transaction_id": 0,
                "cells_to_activate": [msg["cell_id"]]}))
        elif name == "initialULRRCMessageTransfer":
            du_id = msg["gnb_du_ue_id"]
            st = self.by_du_id.setdefault(
                du_id, {"cu_id": self.next_cu_ue_id, "rnti": msg["c_rnti"]})
            self.next_cu_ue_id += 1
            self.rrc.handle_ul(st["rnti"], msg["rrc_container"])
        elif name == "ulRRCMessageTransfer":
            du_id = msg["gnb_du_ue_id"]
            self.rrc.handle_ul(self.by_du_id[du_id]["rnti"],
                               msg["rrc_container"])
        elif name == "ueContextSetupResponse":
            self.by_du_id[msg["gnb_du_ue_id"]]["du_teid"] = msg["du_teid"]


class DuF1ap:
    """DU endpoint: forwards UE RRC PDUs up, delivers DL containers to the
    per-UE deliver_dl callback (SRB toward the UE over the air)."""

    def __init__(self, du_id: int = 1, cell_id: int = 0,
                 send: Callable[[bytes], None] | None = None,
                 deliver_dl: Callable[[int, int, bytes], None] | None = None):
        self.du_id = du_id
        self.cell_id = cell_id
        self.send = send or (lambda pdu: None)
        self.deliver_dl = deliver_dl or (lambda *a: None)
        self.setup_done = False
        self.by_du_id: dict[int, int] = {}       # du_ue_id -> rnti
        self.by_rnti: dict[int, int] = {}
        self.next_du_ue_id = 1

    def f1_setup(self):
        self.send(encode("f1SetupRequest", {
            "gnb_du_id": self.du_id, "cell_id": self.cell_id,
            "plmn_mcc": 1, "plmn_mnc": 1}))

    def initial_ul_rrc(self, rnti: int, rrc_pdu: bytes) -> int:
        du_ue_id = self.next_du_ue_id
        self.next_du_ue_id += 1
        self.by_du_id[du_ue_id] = rnti
        self.by_rnti[rnti] = du_ue_id
        self.send(encode("initialULRRCMessageTransfer", {
            "gnb_du_ue_id": du_ue_id, "c_rnti": rnti,
            "rrc_container": rrc_pdu}))
        return du_ue_id

    def ul_rrc(self, rnti: int, srb_id: int, rrc_pdu: bytes):
        du_ue_id = self.by_rnti[rnti]
        self.send(encode("ulRRCMessageTransfer", {
            "gnb_cu_ue_id": 0, "gnb_du_ue_id": du_ue_id,
            "srb_id": srb_id, "rrc_container": rrc_pdu}))

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "f1SetupResponse":
            self.setup_done = True
        elif name == "dlRRCMessageTransfer":
            rnti = self.by_du_id[msg["gnb_du_ue_id"]]
            self.deliver_dl(rnti, msg["srb_id"], msg["rrc_container"])
        elif name == "ueContextSetupRequest":
            self.send(encode("ueContextSetupResponse", {
                "gnb_cu_ue_id": msg["gnb_cu_ue_id"],
                "gnb_du_ue_id": msg["gnb_du_ue_id"],
                "du_teid": 0x4000 + msg["gnb_du_ue_id"]}))
        elif name == "ueContextReleaseCommand":
            rnti = self.by_du_id.pop(msg["gnb_du_ue_id"], None)
            self.by_rnti.pop(rnti, None)
            self.send(encode("ueContextReleaseComplete", {
                "gnb_cu_ue_id": msg["gnb_cu_ue_id"],
                "gnb_du_ue_id": msg["gnb_du_ue_id"]}))
