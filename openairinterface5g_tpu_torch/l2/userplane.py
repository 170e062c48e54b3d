"""User-plane DRB bundle: PDCP (NEA2) + RLC AM + MAC subPDU framing.

One `DrbStack` per node bundles everything between "IP packet in" and
"MAC TB bytes out" (and the reverse), so the over-the-air loops can
carry a real ciphered, ARQ-protected user plane inside their transport
blocks instead of raw pattern bytes (nr_pdcp_oai_api + nr_rlc entity +
MAC subPDU framing roles).

MAC framing (38.321 subPDU analog): [len u16 BE][RLC PDU]... then a
0x0000 terminator, zero-padded to the TB size.  RLC AM STATUS PDUs ride
the same framing (RlcAm.pdu_in dispatches on the D/C bit).

A copy of openairinterface5g_tpu/l2/userplane.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

from typing import Callable

from .pdcp import DIR_DL, DIR_UL, PdcpConfig, PdcpEntity
from .rlc import RlcAm


class DrbStack:
    """One node's side of a bidirectional DRB.

    tx_dir: DIR_DL for the gNB, DIR_UL for the UE (PDCP cipher stream
    direction of the node's own transmissions)."""

    def __init__(self, tx_dir: int, key: bytes = b"\x11" * 16,
                 bearer_id: int = 1):
        self.delivered: list[bytes] = []
        # one PDCP entity per node: it is a direction PAIR (sdu_in
        # ciphers with cfg.direction, pdu_in deciphers with the inverse)
        self.pdcp = PdcpEntity(
            PdcpConfig(direction=tx_dir, key_enc=key, bearer_id=bearer_id),
            deliver=self.delivered.append)
        self.rlc = RlcAm(deliver=self.pdcp.pdu_in)

    # --- traffic in/out ---

    def send_packet(self, pkt: bytes) -> None:
        self.rlc.sdu_in(self.pdcp.sdu_in(pkt))

    # --- MAC TB boundary ---

    def fill_tb(self, n_bytes: int) -> bytes:
        """Build a TB payload: STATUS first (ARQ feedback has priority,
        38.321 LCP), then AMD PDUs while they fit."""
        out = bytearray()
        self.rlc.tick_reassembly()
        st = self.rlc.status_out()
        if st is not None and len(out) + 2 + len(st) + 2 <= n_bytes:
            out += len(st).to_bytes(2, "big") + st
        while len(out) + 2 + 4 + 2 <= n_bytes:
            pdu = self.rlc.pdu_out(n_bytes - len(out) - 4)
            if pdu is None:
                break
            out += len(pdu).to_bytes(2, "big") + pdu
        out += b"\x00\x00"
        return bytes(out) + b"\x00" * (n_bytes - len(out))

    def drain_tb(self, tb: bytes) -> int:
        """Feed a received TB's subPDUs into RLC; returns subPDU count."""
        off, n = 0, 0
        while off + 2 <= len(tb):
            ln = int.from_bytes(tb[off: off + 2], "big")
            off += 2
            if ln == 0:
                break
            self.rlc.pdu_in(tb[off: off + ln])
            off += ln
            n += 1
        return n
