"""SCTP-style association transport — openair3/SCTP analog.

The reference carries NGAP/F1AP/E1AP/X2AP over kernel SCTP
(sctp_eNB_task.c).  Kernel SCTP is not available in this runtime, so
this module provides the same service surface — message-oriented
delivery with stream IDs and PPIDs over an association — framed on TCP
(and a loopback pair for in-process tests).  Frame: 12-byte header
(stream, ppid, length) + payload; one TCP connection per association,
mirroring how the reference dedicates one SCTP association per peer.

A copy of openairinterface5g_tpu/l3/sctp.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Callable

PPID_NGAP = 60
PPID_F1AP = 62
PPID_E1AP = 64

_HDR = struct.Struct(">HHII")    # stream, reserved, ppid, length


class SctpAssociation:
    """One association endpoint: send(stream, ppid, data) / on_message."""

    def __init__(self, sock: socket.socket,
                 on_message: Callable[[int, int, bytes], None]):
        self.sock = sock
        self.on_message = on_message
        self._alive = True
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()

    def send(self, stream: int, ppid: int, data: bytes) -> None:
        self.sock.sendall(_HDR.pack(stream, 0, ppid, len(data)) + data)

    def _rx_loop(self):
        buf = b""
        try:
            while self._alive:
                chunk = self.sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= _HDR.size:
                    stream, _, ppid, length = _HDR.unpack(buf[:_HDR.size])
                    if len(buf) < _HDR.size + length:
                        break
                    payload = buf[_HDR.size: _HDR.size + length]
                    buf = buf[_HDR.size + length:]
                    self.on_message(stream, ppid, payload)
        except OSError:
            pass

    def close(self):
        self._alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def listen(port: int, on_message, host: str = "127.0.0.1"):
    """Accept ONE association (server side); returns (assoc, bound_port)."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    bound = srv.getsockname()[1]
    holder = {}

    def _accept():
        conn, _ = srv.accept()
        holder["assoc"] = SctpAssociation(conn, on_message)
        srv.close()

    t = threading.Thread(target=_accept, daemon=True)
    t.start()
    return holder, bound, t


def connect(host: str, port: int, on_message) -> SctpAssociation:
    s = socket.socket()
    s.connect((host, port))
    return SctpAssociation(s, on_message)


def loopback_pair(on_a, on_b):
    """In-process association pair (unit tests / L2-sim style loops)."""
    sa, sb = socket.socketpair()
    return SctpAssociation(sa, on_a), SctpAssociation(sb, on_b)
