"""GTP-U (TS 29.281): user-plane tunneling — openair3/ocp-gtpu analog.

Header codec + tunnel endpoint that maps TEIDs to PDU sessions and
carries IP payloads over UDP port 2152 (socket transport optional: the
codec works standalone for in-process loops, matching how the L2
simulator bypasses real sockets).

A copy of openairinterface5g_tpu/l3/gtpu.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
import socket
import struct
from typing import Callable

GTPU_PORT = 2152
MSG_GPDU = 0xFF
MSG_ECHO_REQ = 0x01
MSG_ECHO_RSP = 0x02


@dataclasses.dataclass
class GtpuHeader:
    teid: int
    msg_type: int = MSG_GPDU
    seq: int | None = None

    def encode(self, payload_len: int) -> bytes:
        flags = 0x30                          # v1, PT=1
        length = payload_len
        ext = b""
        if self.seq is not None:
            flags |= 0x02
            length += 4
            ext = struct.pack(">HBB", self.seq, 0, 0)
        return struct.pack(">BBHI", flags, self.msg_type, length,
                           self.teid) + ext


def encode_gpdu(teid: int, payload: bytes, seq: int | None = None) -> bytes:
    return GtpuHeader(teid, MSG_GPDU, seq).encode(len(payload)) + payload


def decode(pkt: bytes) -> tuple[GtpuHeader, bytes]:
    flags, msg_type, length, teid = struct.unpack(">BBHI", pkt[:8])
    assert (flags >> 5) == 1, "GTP version"
    off = 8
    seq = None
    if flags & 0x07:
        seq = struct.unpack(">H", pkt[8:10])[0]
        off = 12
    return GtpuHeader(teid, msg_type, seq), pkt[off: 8 + length]


class GtpuEndpoint:
    """TEID-demuxing tunnel endpoint (gtpv1uTask analog).

    deliver(session_id, payload) receives decapsulated inner packets;
    `send(session_id, payload)` encapsulates toward the peer.  Transport
    is either a UDP socket (bind=True) or a direct callable for
    in-process tests.
    """

    def __init__(self, deliver: Callable[[int, bytes], None] | None = None,
                 transport: Callable[[bytes], None] | None = None,
                 bind: bool = False, addr=("127.0.0.1", 0)):
        self.deliver = deliver or (lambda *a: None)
        self._tx = transport or (lambda pkt: None)
        self.local: dict[int, int] = {}        # local teid -> session
        self.remote: dict[int, int] = {}       # session -> remote teid
        self.seq = 0
        self.sock = None
        if bind:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.bind(addr)
            self.sock.settimeout(1.0)

    def add_session(self, session_id: int, local_teid: int, remote_teid: int):
        self.local[local_teid] = session_id
        self.remote[session_id] = remote_teid

    def send(self, session_id: int, payload: bytes):
        pkt = encode_gpdu(self.remote[session_id], payload)
        self._tx(pkt)
        return pkt

    def receive(self, pkt: bytes):
        hdr, payload = decode(pkt)
        if hdr.msg_type == MSG_ECHO_REQ:
            self._tx(GtpuHeader(hdr.teid, MSG_ECHO_RSP, 0).encode(0))
            return
        if hdr.msg_type == MSG_GPDU and hdr.teid in self.local:
            self.deliver(self.local[hdr.teid], payload)
