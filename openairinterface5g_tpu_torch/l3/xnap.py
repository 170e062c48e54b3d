"""XnAP (TS 38.423): inter-gNB procedures — openair2/X2AP(XNAP) analog.

Procedures: Xn Setup, Handover Preparation (Request / Request Ack),
SN Status Transfer, UE Context Release — enough to drive an Xn handover
between two gNB instances (source forwards the UE's RRC/PDCP state,
target admits and returns the RRC reconfiguration container).

A copy of openairinterface5g_tpu/l3/xnap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

from typing import Callable

from . import per

MESSAGES = {
    "xnSetupRequest": per.Seq((
        ("gnb_id", per.BitStr(32), False),
        ("served_cells", per.SeqOf(per.BitStr(36)), False),
    )),
    "xnSetupResponse": per.Seq((
        ("gnb_id", per.BitStr(32), False),
        ("served_cells", per.SeqOf(per.BitStr(36)), False),
    )),
    "handoverRequest": per.Seq((
        ("source_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("target_cell", per.BitStr(36), False),
        ("c_rnti", per.Int(0, 65535), False),
        ("ue_context", per.OctStr(), False),      # RRC context container
        ("pdcp_sn_dl", per.Int(0, 262143), False),
        ("pdcp_sn_ul", per.Int(0, 262143), False),
    )),
    "handoverRequestAcknowledge": per.Seq((
        ("source_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("target_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("new_c_rnti", per.Int(0, 65535), False),
        ("rrc_reconfig", per.OctStr(), False),    # container for the UE
    )),
    "snStatusTransfer": per.Seq((
        ("target_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("pdcp_sn_dl", per.Int(0, 262143), False),
        ("pdcp_sn_ul", per.Int(0, 262143), False),
    )),
    "ueContextRelease": per.Seq((
        ("source_ue_id", per.Int(0, (1 << 32) - 1), False),
        ("target_ue_id", per.Int(0, (1 << 32) - 1), False),
    )),
}

WRAPPER = per.Choice(tuple((n, MESSAGES[n]) for n in sorted(MESSAGES)))


def encode(name: str, msg: dict) -> bytes:
    return per.encode(WRAPPER, (name, msg))


def decode(pdu: bytes):
    return per.decode(WRAPPER, pdu)


class XnEndpoint:
    """One gNB's Xn endpoint; pair two of them for a handover loop."""

    def __init__(self, gnb_id: int, cells: list[int],
                 send: Callable[[bytes], None] | None = None):
        self.gnb_id = gnb_id
        self.cells = cells
        self.send = send or (lambda pdu: None)
        self.peer_cells: list[int] = []
        self.setup_done = False
        self.next_ue_id = 1
        self.admitted: dict[int, dict] = {}     # target-side UE contexts
        self.completed: list[int] = []          # source-side released UEs
        self.pending_ho: dict[int, dict] = {}

    def xn_setup(self):
        self.send(encode("xnSetupRequest",
                         {"gnb_id": self.gnb_id, "served_cells": self.cells}))

    def start_handover(self, ue_id: int, target_cell: int, c_rnti: int,
                       ue_context: bytes, sn_dl: int = 0, sn_ul: int = 0):
        self.pending_ho[ue_id] = {"c_rnti": c_rnti}
        self.send(encode("handoverRequest", {
            "source_ue_id": ue_id, "target_cell": target_cell,
            "c_rnti": c_rnti, "ue_context": ue_context,
            "pdcp_sn_dl": sn_dl, "pdcp_sn_ul": sn_ul}))

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "xnSetupRequest":
            self.peer_cells = msg["served_cells"]
            self.send(encode("xnSetupResponse",
                             {"gnb_id": self.gnb_id, "served_cells": self.cells}))
        elif name == "xnSetupResponse":
            self.peer_cells = msg["served_cells"]
            self.setup_done = True
        elif name == "handoverRequest":
            # admission control: accept if the target cell is served here
            if msg["target_cell"] not in self.cells:
                return
            tid = self.next_ue_id
            self.next_ue_id += 1
            new_rnti = 0xC000 + tid
            self.admitted[tid] = {
                "context": msg["ue_context"], "c_rnti": new_rnti,
                "pdcp_sn_dl": msg["pdcp_sn_dl"],
                "pdcp_sn_ul": msg["pdcp_sn_ul"]}
            self.send(encode("handoverRequestAcknowledge", {
                "source_ue_id": msg["source_ue_id"], "target_ue_id": tid,
                "new_c_rnti": new_rnti, "rrc_reconfig": b"ho-reconfig"}))
        elif name == "handoverRequestAcknowledge":
            ue_id = msg["source_ue_id"]
            self.pending_ho[ue_id]["ack"] = msg
            # source sends SN status and releases after the UE leaves
            self.send(encode("snStatusTransfer", {
                "target_ue_id": msg["target_ue_id"],
                "pdcp_sn_dl": 100, "pdcp_sn_ul": 50}))
            self.send(encode("ueContextRelease", {
                "source_ue_id": ue_id, "target_ue_id": msg["target_ue_id"]}))
            self.completed.append(ue_id)
        elif name == "snStatusTransfer":
            ctx = self.admitted.get(msg["target_ue_id"])
            if ctx:
                ctx["pdcp_sn_dl"] = msg["pdcp_sn_dl"]
                ctx["pdcp_sn_ul"] = msg["pdcp_sn_ul"]
        elif name == "ueContextRelease":
            pass                                  # source-side cleanup ack
