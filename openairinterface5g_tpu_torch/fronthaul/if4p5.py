"""IF4p5-analog fronthaul packet format: frequency-domain IQ per symbol.

The reference's IF4p5 split sends per-symbol frequency-domain IQ between
the RU (radio + FEP) and L1 over raw ethernet/UDP with a data_block of
int16 IQ pairs (radio/ETHERNET/, packet build/parse in
executables/nr-ru.c:278-600 fh_if4p5_south_* / north_*).  This is the
clean-room analog: one UDP datagram per (slot, symbol, antenna) carrying
block-floating-point int16 IQ for the occupied subcarriers, plus a
per-packet float scale (the O-RAN udCompHdr/BFP-exponent role).

Header (little-endian, 24 bytes):
  magic   u32  0x49463435 ("IF45")
  type    u8   0 = UL freq-domain (RU -> L1), 1 = DL freq-domain (L1 -> RU)
  frame   u16
  slot    u8
  symbol  u8
  antenna u8
  n_sc    u16  occupied subcarriers in this packet
  seq     u32  monotonically increasing per sender
  scale   f32  amplitude that int16 32767 maps to
  pad     u16
payload: n_sc int16 IQ pairs (re, im interleaved)

A copy of openairinterface5g_tpu/fronthaul/if4p5.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
import socket
import struct

import numpy as np

MAGIC = 0x49463435
_HDR = struct.Struct("<IBHBBBHIfH")
UL_FD = 0
DL_FD = 1


@dataclasses.dataclass
class If4p5Packet:
    pkt_type: int
    frame: int
    slot: int
    symbol: int
    antenna: int
    seq: int
    iq: np.ndarray          # (n_sc,) complex64


def pack(p: If4p5Packet) -> bytes:
    x = np.asarray(p.iq, np.complex64)
    scale = float(np.max(np.abs(np.stack([x.real, x.imag])))) or 1.0
    q = np.empty(2 * len(x), np.int16)
    q[0::2] = np.clip(np.round(x.real / scale * 32767), -32768, 32767)
    q[1::2] = np.clip(np.round(x.imag / scale * 32767), -32768, 32767)
    hdr = _HDR.pack(MAGIC, p.pkt_type, p.frame, p.slot, p.symbol,
                    p.antenna, len(x), p.seq, scale, 0)
    return hdr + q.tobytes()


def unpack(buf: bytes) -> If4p5Packet:
    (magic, typ, frame, slot, symbol, ant, n_sc, seq, scale,
     _pad) = _HDR.unpack_from(buf, 0)
    assert magic == MAGIC, f"bad IF4p5 magic {magic:#x}"
    q = np.frombuffer(buf, np.int16, count=2 * n_sc, offset=_HDR.size)
    iq = (q[0::2].astype(np.float32)
          + 1j * q[1::2].astype(np.float32)) * (scale / 32767.0)
    return If4p5Packet(typ, frame, slot, symbol, ant, seq,
                       iq.astype(np.complex64))


class If4p5Link:
    """UDP endpoint exchanging per-symbol freq-domain IQ grids."""

    def __init__(self, local_port: int, peer: tuple[str, int] | None = None,
                 timeout_s: float = 30.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", local_port))
        self.sock.settimeout(timeout_s)
        self.peer = peer
        self.seq = 0

    def send_grid(self, pkt_type: int, frame: int, slot: int,
                  grid: np.ndarray) -> None:
        """grid: (n_ant, n_symbols, n_sc) complex64 -> one packet per
        (symbol, antenna) — the fh_if4p5_south_out symbol loop analog."""
        n_ant, n_sym, _ = grid.shape
        for s in range(n_sym):
            for a in range(n_ant):
                self.sock.sendto(
                    pack(If4p5Packet(pkt_type, frame, slot, s, a, self.seq,
                                     grid[a, s])), self.peer)
                self.seq += 1

    def recv_grid(self, n_ant: int, n_symbols: int,
                  n_sc: int) -> tuple[int, int, int, np.ndarray]:
        """Reassemble one slot's grid; returns (type, frame, slot, grid).

        Packets may arrive in any order and interleave across slots (UDP);
        partial slots are buffered until complete, completed slots are
        returned oldest-first."""
        if not hasattr(self, "_partial"):
            self._partial: dict = {}
            self._done: list = []
        if self._done:
            return self._done.pop(0)
        need = n_ant * n_symbols
        while True:
            buf, addr = self.sock.recvfrom(65535)
            if self.peer is None:
                self.peer = addr
            p = unpack(buf)
            key = (p.pkt_type, p.frame, p.slot)
            grid, got = self._partial.setdefault(
                key, (np.zeros((n_ant, n_symbols, n_sc), np.complex64), set()))
            grid[p.antenna, p.symbol, : len(p.iq)] = p.iq
            got.add((p.symbol, p.antenna))
            if len(got) >= need:
                del self._partial[key]
                return (*key, grid)

    def send_ack(self, frame: int, slot: int) -> None:
        """Per-slot flow-control credit (the reference paces IF4p5 by the
        radio clock; over loopback UDP an explicit ack avoids bursts
        overflowing socket buffers)."""
        self.sock.sendto(struct.pack("<IHB", MAGIC ^ 1, frame, slot),
                         self.peer)

    def wait_ack(self) -> tuple[int, int]:
        while True:
            buf, _ = self.sock.recvfrom(65535)
            if len(buf) == 7:
                m, f, s = struct.unpack("<IHB", buf)
                if m == MAGIC ^ 1:
                    return f, s

    def close(self):
        self.sock.close()
