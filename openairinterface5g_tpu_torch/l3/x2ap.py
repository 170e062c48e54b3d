"""X2AP (TS 36.423): inter-eNB procedures — openair2/X2AP analog.

The LTE sibling of xnap.py: X2 Setup, Handover Preparation (Request /
Request Ack / Preparation Failure), SN Status Transfer, UE Context
Release, plus the EN-DC flavor (SgNB Addition Request/Ack) used for
NSA — enough to drive an X2 handover between two eNB instances and an
EN-DC secondary-node addition toward a gNB.

A copy of openairinterface5g_tpu/l3/x2ap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

from typing import Callable

from . import per

MESSAGES = {
    "x2SetupRequest": per.Seq((
        ("enb_id", per.BitStr(20), False),
        ("served_cells", per.SeqOf(per.BitStr(28)), False),
    )),
    "x2SetupResponse": per.Seq((
        ("enb_id", per.BitStr(20), False),
        ("served_cells", per.SeqOf(per.BitStr(28)), False),
    )),
    "handoverRequest": per.Seq((
        ("old_ue_x2ap_id", per.Int(0, 4095), False),
        ("target_cell", per.BitStr(28), False),
        ("cause", per.Int(0, 255), False),
        ("ue_context", per.OctStr(), False),       # RRC context container
        ("erab_ids", per.SeqOf(per.Int(0, 15)), False),
    )),
    "handoverRequestAcknowledge": per.Seq((
        ("old_ue_x2ap_id", per.Int(0, 4095), False),
        ("new_ue_x2ap_id", per.Int(0, 4095), False),
        ("admitted_erabs", per.SeqOf(per.Int(0, 15)), False),
        ("rrc_container", per.OctStr(), False),    # HandoverCommand
    )),
    "handoverPreparationFailure": per.Seq((
        ("old_ue_x2ap_id", per.Int(0, 4095), False),
        ("cause", per.Int(0, 255), False),
    )),
    "snStatusTransfer": per.Seq((
        ("old_ue_x2ap_id", per.Int(0, 4095), False),
        ("new_ue_x2ap_id", per.Int(0, 4095), False),
        ("pdcp_sn_dl", per.Int(0, 4095), False),
        ("pdcp_sn_ul", per.Int(0, 4095), False),
    )),
    "ueContextRelease": per.Seq((
        ("old_ue_x2ap_id", per.Int(0, 4095), False),
        ("new_ue_x2ap_id", per.Int(0, 4095), False),
    )),
    # EN-DC (36.423 §8.7): NSA secondary-node addition toward a gNB
    "sgnbAdditionRequest": per.Seq((
        ("menb_ue_x2ap_id", per.Int(0, 4095), False),
        ("nr_cell", per.BitStr(36), False),
        ("erab_ids", per.SeqOf(per.Int(0, 15)), False),
    )),
    "sgnbAdditionRequestAcknowledge": per.Seq((
        ("menb_ue_x2ap_id", per.Int(0, 4095), False),
        ("sgnb_ue_x2ap_id", per.Int(0, 4095), False),
        ("nr_rrc_container", per.OctStr(), False),
    )),
}

WRAPPER = per.Choice(tuple((n, MESSAGES[n]) for n in sorted(MESSAGES)))


def encode(name: str, msg: dict) -> bytes:
    return per.encode(WRAPPER, (name, msg))


def decode(pdu: bytes):
    return per.decode(WRAPPER, pdu)


class X2Endpoint:
    """One eNB's X2 endpoint; pair two for handover / EN-DC loops."""

    def __init__(self, enb_id: int, cells: list[int],
                 send: Callable[[bytes], None] | None = None,
                 admit: Callable[[dict], bool] | None = None):
        self.enb_id = enb_id
        self.cells = cells
        self.send = send or (lambda pdu: None)
        self.admit = admit or (lambda msg: True)
        self.peer_cells: list[int] = []
        self.setup_done = False
        self.next_ue_id = 1
        self.admitted: dict[int, dict] = {}
        self.completed: list[int] = []
        self.failed: list[int] = []
        self.pending_ho: dict[int, dict] = {}
        self.sgnb: dict[int, dict] = {}

    def x2_setup(self):
        self.send(encode("x2SetupRequest",
                         {"enb_id": self.enb_id, "served_cells": self.cells}))

    def start_handover(self, ue_id: int, target_cell: int,
                       ue_context: bytes, erabs=(5,)):
        self.pending_ho[ue_id] = {}
        self.send(encode("handoverRequest", {
            "old_ue_x2ap_id": ue_id, "target_cell": target_cell,
            "cause": 0, "ue_context": ue_context,
            "erab_ids": list(erabs)}))

    def start_sgnb_addition(self, ue_id: int, nr_cell: int, erabs=(5,)):
        self.send(encode("sgnbAdditionRequest", {
            "menb_ue_x2ap_id": ue_id, "nr_cell": nr_cell,
            "erab_ids": list(erabs)}))

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "x2SetupRequest":
            self.peer_cells = msg["served_cells"]
            self.send(encode("x2SetupResponse",
                             {"enb_id": self.enb_id,
                              "served_cells": self.cells}))
        elif name == "x2SetupResponse":
            self.peer_cells = msg["served_cells"]
            self.setup_done = True
        elif name == "handoverRequest":
            if msg["target_cell"] not in self.cells or not self.admit(msg):
                self.send(encode("handoverPreparationFailure", {
                    "old_ue_x2ap_id": msg["old_ue_x2ap_id"], "cause": 1}))
                return
            tid = self.next_ue_id
            self.next_ue_id += 1
            self.admitted[tid] = {"context": msg["ue_context"],
                                  "erabs": msg["erab_ids"],
                                  "pdcp_sn_dl": 0, "pdcp_sn_ul": 0}
            self.send(encode("handoverRequestAcknowledge", {
                "old_ue_x2ap_id": msg["old_ue_x2ap_id"],
                "new_ue_x2ap_id": tid,
                "admitted_erabs": msg["erab_ids"],
                "rrc_container": b"lte-ho-command"}))
        elif name == "handoverRequestAcknowledge":
            ue_id = msg["old_ue_x2ap_id"]
            self.pending_ho[ue_id]["ack"] = msg
            self.send(encode("snStatusTransfer", {
                "old_ue_x2ap_id": ue_id,
                "new_ue_x2ap_id": msg["new_ue_x2ap_id"],
                "pdcp_sn_dl": 100, "pdcp_sn_ul": 50}))
            self.send(encode("ueContextRelease", {
                "old_ue_x2ap_id": ue_id,
                "new_ue_x2ap_id": msg["new_ue_x2ap_id"]}))
            self.completed.append(ue_id)
        elif name == "handoverPreparationFailure":
            self.failed.append(msg["old_ue_x2ap_id"])
            self.pending_ho.pop(msg["old_ue_x2ap_id"], None)
        elif name == "snStatusTransfer":
            ctx = self.admitted.get(msg["new_ue_x2ap_id"])
            if ctx:
                ctx["pdcp_sn_dl"] = msg["pdcp_sn_dl"]
                ctx["pdcp_sn_ul"] = msg["pdcp_sn_ul"]
        elif name == "ueContextRelease":
            pass
        elif name == "sgnbAdditionRequest":
            tid = self.next_ue_id
            self.next_ue_id += 1
            self.sgnb[tid] = {"erabs": msg["erab_ids"],
                              "menb_id": msg["menb_ue_x2ap_id"]}
            self.send(encode("sgnbAdditionRequestAcknowledge", {
                "menb_ue_x2ap_id": msg["menb_ue_x2ap_id"],
                "sgnb_ue_x2ap_id": tid,
                "nr_rrc_container": b"nr-scg-config"}))
        elif name == "sgnbAdditionRequestAcknowledge":
            self.sgnb[msg["menb_ue_x2ap_id"]] = {
                "sgnb_id": msg["sgnb_ue_x2ap_id"],
                "scg": msg["nr_rrc_container"]}
