"""NR PDCP entity (TS 38.323): SN/HFN, header, ciphering (NEA2) and
integrity (NIA2) — compact analog of openair2/LAYER2/nr_pdcp
(nr_pdcp_entity.c, nr_pdcp_security_nea2.c, nr_pdcp_integrity_nia2.c).

A copy of openairinterface5g_tpu/l2/pdcp.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .security import nea2, nia2

DIR_UL = 0
DIR_DL = 1


@dataclasses.dataclass
class PdcpConfig:
    sn_bits: int = 18             # 12 or 18 (DRB), 12 (SRB)
    bearer_id: int = 1
    integrity: bool = False       # SRBs / optionally DRBs
    ciphering: bool = True
    key_enc: bytes = b"\x00" * 16
    key_int: bytes = b"\x00" * 16
    direction: int = DIR_DL       # of TX


class PdcpEntity:
    """One PDCP entity (per DRB/SRB, one direction pair)."""

    def __init__(self, cfg: PdcpConfig, deliver: Callable[[bytes], None],
                 on_integrity_fail: Callable[[int], None] = lambda c: None):
        self.cfg = cfg
        self.deliver = deliver
        self.on_integrity_fail = on_integrity_fail
        self.tx_next = 0           # COUNT = HFN << sn_bits | SN
        self.rx_next = 0
        self.rx_deliv = 0
        self.reorder: dict[int, bytes] = {}

    @property
    def _sn_mask(self) -> int:
        return (1 << self.cfg.sn_bits) - 1

    def _header(self, sn: int) -> bytes:
        if self.cfg.sn_bits == 12:
            return bytes([0x80 | (sn >> 8) & 0x0F, sn & 0xFF])
        return bytes([0x80 | (sn >> 16) & 0x03, (sn >> 8) & 0xFF, sn & 0xFF])

    def _parse_header(self, pdu: bytes):
        if self.cfg.sn_bits == 12:
            return ((pdu[0] & 0x0F) << 8) | pdu[1], pdu[2:]
        return ((pdu[0] & 0x03) << 16) | (pdu[1] << 8) | pdu[2], pdu[3:]

    # --- TX: SDU -> PDU ---

    def sdu_in(self, sdu: bytes) -> bytes:
        cfg = self.cfg
        count = self.tx_next
        sn = count & self._sn_mask
        hdr = self._header(sn)
        body = sdu
        if cfg.integrity:
            mac = nia2(cfg.key_int, count, cfg.bearer_id, cfg.direction,
                       hdr + body)
        else:
            mac = b""
        if cfg.ciphering:
            body = nea2(cfg.key_enc, count, cfg.bearer_id, cfg.direction,
                        body + mac)
        else:
            body = body + mac
        self.tx_next += 1
        return hdr + body

    # --- RX: PDU -> SDU (with COUNT estimation, 38.323 §5.2.2.1) ---

    def _est_count(self, sn: int) -> int:
        win = 1 << (self.cfg.sn_bits - 1)
        rx_deliv_sn = self.rx_deliv & self._sn_mask
        hfn = self.rx_deliv >> self.cfg.sn_bits
        if sn < (rx_deliv_sn - win) % (self._sn_mask + 1) and rx_deliv_sn >= win:
            hfn += 1
        elif sn >= rx_deliv_sn + win:
            hfn -= 1
        return max(0, (hfn << self.cfg.sn_bits) | sn)

    def pdu_in(self, pdu: bytes) -> Optional[bytes]:
        cfg = self.cfg
        sn, body = self._parse_header(pdu)
        count = self._est_count(sn)
        rx_dir = 1 - cfg.direction
        if cfg.ciphering:
            body = nea2(cfg.key_enc, count, cfg.bearer_id, rx_dir, body)
        if cfg.integrity:
            body, mac = body[:-4], body[-4:]
            hdr = pdu[: len(pdu) - len(body) - 4]
            exp = nia2(cfg.key_int, count, cfg.bearer_id, rx_dir, hdr + body)
            if mac != exp:
                self.on_integrity_fail(count)
                return None
        # in-order delivery with reordering buffer
        if count < self.rx_deliv:
            return None               # duplicate
        self.reorder[count] = body
        delivered = None
        while self.rx_deliv in self.reorder:
            delivered = self.reorder.pop(self.rx_deliv)
            self.deliver(delivered)
            self.rx_deliv += 1
        self.rx_next = max(self.rx_next, count + 1)
        return delivered
