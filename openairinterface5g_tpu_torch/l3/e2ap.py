"""E2AP RIC agent (O-RAN E2AP + KPM service model subset) —
openair2/E2AP analog (the reference embeds an O-RAN SC E2 agent,
nr-softmodem.c:730 --e2-agent).

Procedures: E2 Setup (RAN function list), RIC Subscription, RIC
Indication (periodic KPM report carrying the MAC scheduler's per-UE
stats), RIC Control (e.g. forcing a max-MCS cap — the kind of closed
loop xApps drive).

A copy of openairinterface5g_tpu/l3/e2ap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

import json
from typing import Callable

from . import per

MESSAGES = {
    "e2SetupRequest": per.Seq((
        ("ran_function_ids", per.SeqOf(per.Int(0, 4095)), False),
        ("gnb_id", per.BitStr(32), False),
    )),
    "e2SetupResponse": per.Seq((
        ("accepted_functions", per.SeqOf(per.Int(0, 4095)), False),
    )),
    "ricSubscriptionRequest": per.Seq((
        ("request_id", per.Int(0, 65535), False),
        ("ran_function_id", per.Int(0, 4095), False),
        ("report_period_ms", per.Int(1, 10000), False),
    )),
    "ricSubscriptionResponse": per.Seq((
        ("request_id", per.Int(0, 65535), False),
    )),
    "ricIndication": per.Seq((
        ("request_id", per.Int(0, 65535), False),
        ("sn", per.Int(0, 65535), False),
        ("kpm_report", per.OctStr(), False),      # JSON KPM payload
    )),
    "ricControlRequest": per.Seq((
        ("request_id", per.Int(0, 65535), False),
        ("control", per.OctStr(), False),          # JSON control payload
    )),
    "ricControlAck": per.Seq((
        ("request_id", per.Int(0, 65535), False),
    )),
}

WRAPPER = per.Choice(tuple((n, MESSAGES[n]) for n in sorted(MESSAGES)))

RAN_FUNC_KPM = 2
RAN_FUNC_RC = 3


def encode(name: str, msg: dict) -> bytes:
    return per.encode(WRAPPER, (name, msg))


def decode(pdu: bytes):
    return per.decode(WRAPPER, pdu)


class E2Agent:
    """gNB-side agent: answers subscriptions with KPM indications built
    from a stats provider callable (the MAC scheduler's UE table)."""

    def __init__(self, gnb_id: int = 1,
                 send: Callable[[bytes], None] | None = None,
                 stats_provider: Callable[[], dict] | None = None,
                 control_sink: Callable[[dict], None] | None = None):
        self.gnb_id = gnb_id
        self.send = send or (lambda pdu: None)
        self.stats_provider = stats_provider or (lambda: {})
        self.control_sink = control_sink or (lambda c: None)
        self.setup_done = False
        self.subs: dict[int, int] = {}           # request_id -> period_ms
        self.sn = 0

    def e2_setup(self):
        self.send(encode("e2SetupRequest", {
            "ran_function_ids": [RAN_FUNC_KPM, RAN_FUNC_RC],
            "gnb_id": self.gnb_id}))

    def tick(self):
        """Emit one indication per active subscription (called on the
        report cadence by the softmodem loop)."""
        report = json.dumps(self.stats_provider()).encode()
        for req_id in self.subs:
            self.sn = (self.sn + 1) % 65536
            self.send(encode("ricIndication", {
                "request_id": req_id, "sn": self.sn, "kpm_report": report}))

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "e2SetupResponse":
            self.setup_done = True
        elif name == "ricSubscriptionRequest":
            self.subs[msg["request_id"]] = msg["report_period_ms"]
            self.send(encode("ricSubscriptionResponse",
                             {"request_id": msg["request_id"]}))
        elif name == "ricControlRequest":
            self.control_sink(json.loads(msg["control"].decode()))
            self.send(encode("ricControlAck", {"request_id": msg["request_id"]}))


class RicStub:
    """Near-RT RIC stand-in for closed-loop tests / demos."""

    def __init__(self, send: Callable[[bytes], None] | None = None):
        self.send = send or (lambda pdu: None)
        self.indications: list[dict] = []
        self.functions: list[int] = []
        self.next_req = 1

    def subscribe(self, period_ms: int = 100) -> int:
        req = self.next_req
        self.next_req += 1
        self.send(encode("ricSubscriptionRequest", {
            "request_id": req, "ran_function_id": RAN_FUNC_KPM,
            "report_period_ms": period_ms}))
        return req

    def control(self, payload: dict) -> int:
        req = self.next_req
        self.next_req += 1
        self.send(encode("ricControlRequest", {
            "request_id": req, "control": json.dumps(payload).encode()}))
        return req

    def handle(self, pdu: bytes):
        name, msg = decode(pdu)
        if name == "e2SetupRequest":
            self.functions = msg["ran_function_ids"]
            self.send(encode("e2SetupResponse",
                             {"accepted_functions": msg["ran_function_ids"]}))
        elif name == "ricIndication":
            self.indications.append(json.loads(msg["kpm_report"].decode()))
