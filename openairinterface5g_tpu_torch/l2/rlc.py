"""NR RLC entities: TM / UM / AM (TS 38.322), compact functional analog of
openair2/LAYER2/nr_rlc (nr_rlc_entity_am.c / _um.c / _tm.c).

Implements the data-path state machines the reference unit-tests with its
golden-trace harness (nr_rlc/tests/test.c):
  - UM: 6/12-bit SN, segmentation with SO, reassembly window,
    t-Reassembly discard
  - AM: 12/18-bit SN, segmentation, status PDUs (ACK_SN + NACK list with
    SO ranges), retransmission on NACK, poll bit / t-PollRetransmit,
    max-retx notification
PDU formats follow 38.322 §6.2.2 (the header layouts; byte-exact fields,
built with int arithmetic rather than bitfield structs).

A copy of openairinterface5g_tpu/l2/rlc.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# segmentation info values (38.322 §6.2.2.4 SI field)
SI_FULL = 0
SI_FIRST = 1
SI_LAST = 2
SI_MIDDLE = 3


@dataclasses.dataclass
class RlcSdu:
    data: bytes
    sn: int = -1


class RlcTm:
    """Transparent mode: pass-through (SRB0/BCCH)."""

    def __init__(self, deliver: Callable[[bytes], None]):
        self.deliver = deliver
        self.queue: list[bytes] = []

    def sdu_in(self, data: bytes):
        self.queue.append(data)

    def pdu_out(self, size: int) -> Optional[bytes]:
        if not self.queue or len(self.queue[0]) > size:
            return None
        return self.queue.pop(0)

    def pdu_in(self, pdu: bytes):
        self.deliver(pdu)


class RlcUm:
    """UM entity (38.322 §5.2.2): segmentation + reassembly, no ARQ."""

    def __init__(self, deliver: Callable[[bytes], None], sn_bits: int = 12,
                 t_reassembly_slots: int = 35):
        assert sn_bits in (6, 12)
        self.deliver = deliver
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.t_reassembly = t_reassembly_slots
        self.tx_next = 0
        self.queue: list[RlcSdu] = []
        self.cur: Optional[RlcSdu] = None
        self.cur_off = 0
        # reassembly state: sn -> {so: bytes}, plus last-segment flag
        self.rx_segs: dict[int, dict[int, bytes]] = {}
        self.rx_last_so: dict[int, int] = {}
        self.rx_timer: dict[int, int] = {}
        self.now = 0

    # --- TX ---

    def sdu_in(self, data: bytes):
        self.queue.append(RlcSdu(data))

    def _header(self, si: int, sn: int, so: int) -> bytes:
        if si == SI_FULL:
            return bytes([si << 6])
        if self.sn_bits == 6:
            h = bytes([(si << 6) | sn])
        else:
            h = bytes([(si << 6) | (sn >> 8), sn & 0xFF])
        if si in (SI_MIDDLE, SI_LAST):
            h += bytes([(so >> 8) & 0xFF, so & 0xFF])
        return h

    def pdu_out(self, size: int) -> Optional[bytes]:
        """Build one UMD PDU up to `size` bytes (mac_rlc_data_req analog)."""
        if self.cur is None:
            if not self.queue:
                return None
            self.cur = self.queue.pop(0)
            self.cur_off = 0
        data = self.cur.data
        first = self.cur_off == 0
        remaining = len(data) - self.cur_off
        # header size depends on SI; try full first
        if first and remaining + 1 <= size:
            pdu = self._header(SI_FULL, 0, 0) + data
            self.cur = None
            return pdu
        hdr_len = (1 if self.sn_bits == 6 else 2) + (0 if first else 2)
        room = size - hdr_len
        if room <= 0:
            return None
        sn = self.tx_next
        if remaining <= room:           # last segment
            pdu = self._header(SI_LAST, sn, self.cur_off) + data[self.cur_off:]
            self.cur = None
            self.tx_next = (self.tx_next + 1) % self.mod
            return pdu
        si = SI_FIRST if first else SI_MIDDLE
        pdu = self._header(si, sn, self.cur_off) + \
            data[self.cur_off: self.cur_off + room]
        self.cur_off += room
        return pdu

    # --- RX ---

    def pdu_in(self, pdu: bytes):
        si = pdu[0] >> 6
        if si == SI_FULL:
            self.deliver(pdu[1:])
            return
        if self.sn_bits == 6:
            sn = pdu[0] & 0x3F
            off = 1
        else:
            sn = ((pdu[0] & 0x3F) << 8) | pdu[1]
            off = 2
        so = 0
        if si in (SI_MIDDLE, SI_LAST):
            so = (pdu[off] << 8) | pdu[off + 1]
            off += 2
        segs = self.rx_segs.setdefault(sn, {})
        segs[so] = pdu[off:]
        self.rx_timer.setdefault(sn, self.now + self.t_reassembly)
        if si == SI_LAST:
            self.rx_last_so[sn] = so
        self._try_reassemble(sn)

    def _try_reassemble(self, sn: int):
        if sn not in self.rx_last_so:
            return
        segs = self.rx_segs.get(sn, {})
        data = b""
        while len(data) in segs:
            data += segs[len(data)]
        if len(data) > self.rx_last_so[sn]:
            self.deliver(data)
            self.rx_segs.pop(sn, None)
            self.rx_last_so.pop(sn, None)
            self.rx_timer.pop(sn, None)

    def tick(self, now: int):
        """Advance time; discard expired partial SDUs (t-Reassembly)."""
        self.now = now
        for sn in [s for s, t in self.rx_timer.items() if t <= now]:
            self.rx_segs.pop(sn, None)
            self.rx_last_so.pop(sn, None)
            self.rx_timer.pop(sn, None)


class RlcAm:
    """AM entity (38.322 §5.3): ARQ with SDU segmentation (SI/SO) +
    status reporting + retransmission.

    Simplified relative to the reference in retransmission granularity
    (a NACKed SN retransmits the whole SDU, re-segmented to the current
    grant; NACKs are per-SN without SO ranges) but the protocol
    artifacts — AMD headers with P/SI/SO, STATUS PDU with ACK_SN /
    NACK_SN list, max_retx notification — match nr_rlc_entity_am.c.
    """

    SI_FULL, SI_FIRST, SI_LAST, SI_MIDDLE = 0, 1, 2, 3

    def __init__(self, deliver: Callable[[bytes], None], sn_bits: int = 12,
                 max_retx: int = 4, poll_pdu: int = 4,
                 on_max_retx: Callable[[int], None] = lambda sn: None):
        assert sn_bits in (12, 18)
        self.deliver = deliver
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.max_retx = max_retx
        self.poll_pdu = poll_pdu
        self.on_max_retx = on_max_retx
        self.tx_next = 0
        self.tx_acked = 0            # lowest un-acked SN
        self.queue: list[bytes] = []
        self.wait_ack: dict[int, bytes] = {}
        self.retx: list[int] = []
        self.retx_count: dict[int, int] = {}
        self.tx_seg: tuple | None = None    # (sn, data, offset) in progress
        self.pdu_since_poll = 0
        self.rx_next = 0             # next expected SN
        self.rx_buf: dict[int, bytes] = {}
        self.rx_segs: dict[int, dict] = {}  # sn -> {so: bytes, 'last': end}
        self.status_due = False

    # --- TX side ---

    def sdu_in(self, data: bytes):
        self.queue.append(data)

    def _amd_header(self, sn: int, poll: bool, si: int = 0,
                    so: int = 0) -> bytes:
        # D/C=1 | P | SI(2) | SN; SO (2 bytes) present for SI middle/last
        if self.sn_bits == 12:
            hdr = bytes([0x80 | (0x40 if poll else 0) | (si << 4)
                         | (sn >> 8), sn & 0xFF])
        else:
            hdr = bytes([0x80 | (0x40 if poll else 0) | (si << 4)
                         | (sn >> 16), (sn >> 8) & 0xFF, sn & 0xFF])
        if si in (self.SI_MIDDLE, self.SI_LAST):
            hdr += so.to_bytes(2, "big")
        return hdr

    def _hdr_len(self, si: int) -> int:
        base = 2 if self.sn_bits == 12 else 3
        return base + (2 if si in (self.SI_MIDDLE, self.SI_LAST) else 0)

    def _emit(self, sn: int, data: bytes, offset: int, size: int,
              poll: bool):
        """One (possibly segmented) AMD PDU for `data` from `offset`;
        updates tx_seg.  Returns the PDU."""
        total = len(data)
        if offset == 0 and self._hdr_len(self.SI_FULL) + total <= size:
            self.tx_seg = None
            return self._amd_header(sn, poll) + data
        si_try = self.SI_FIRST if offset == 0 else self.SI_MIDDLE
        room = size - self._hdr_len(self.SI_LAST if si_try != self.SI_FIRST
                                    else self.SI_FIRST)
        if room <= 0:
            return None
        end = min(offset + room, total)
        if end == total:
            si = self.SI_LAST if offset else self.SI_FULL
            self.tx_seg = None
        else:
            si = self.SI_FIRST if offset == 0 else self.SI_MIDDLE
            self.tx_seg = (sn, data, end)
        return self._amd_header(sn, poll, si, offset) + data[offset:end]

    def pdu_out(self, size: int) -> Optional[bytes]:
        if self.status_due:
            return None                 # control PDU has priority via status_out
        if self.tx_seg is not None:
            sn, data, off = self.tx_seg
            return self._emit(sn, data, off, size, poll=False)
        if self.retx:
            sn = self.retx[0]
            data = self.wait_ack.get(sn)
            if data is None:
                self.retx.pop(0)
                return self.pdu_out(size)
            pdu = self._emit(sn, data, 0, size, poll=True)
            if pdu is not None:
                self.retx.pop(0)
                self.retx_count[sn] = self.retx_count.get(sn, 0) + 1
                if self.retx_count[sn] > self.max_retx:
                    self.on_max_retx(sn)
            return pdu
        if not self.queue:
            return None
        sn = self.tx_next
        data = self.queue[0]
        self.pdu_since_poll += 1
        poll = self.pdu_since_poll >= self.poll_pdu or len(self.queue) == 1
        pdu = self._emit(sn, data, 0, size, poll)
        if pdu is None:
            self.pdu_since_poll -= 1
            return None
        self.queue.pop(0)
        self.tx_next = (self.tx_next + 1) % self.mod
        self.wait_ack[sn] = data
        if poll:
            self.pdu_since_poll = 0
        return pdu

    # --- RX side ---

    def pdu_in(self, pdu: bytes):
        if not pdu[0] & 0x80:
            self._status_in(pdu)
            return
        poll = bool(pdu[0] & 0x40)
        si = (pdu[0] >> 4) & 0x03
        if self.sn_bits == 12:
            sn = ((pdu[0] & 0x0F) << 8) | pdu[1]
            rest = pdu[2:]
        else:
            sn = ((pdu[0] & 0x03) << 16) | (pdu[1] << 8) | pdu[2]
            rest = pdu[3:]
        so = 0
        if si in (self.SI_MIDDLE, self.SI_LAST):
            so = int.from_bytes(rest[:2], "big")
            rest = rest[2:]
        if not self._sn_lt(sn, self.rx_next):
            if si == self.SI_FULL:
                self.rx_buf[sn] = rest
                self.rx_segs.pop(sn, None)   # a full retx supersedes segments
            else:
                segs = self.rx_segs.setdefault(sn, {})
                segs[so] = rest
                if si == self.SI_LAST:
                    segs["end"] = so + len(rest)
                # reassemble when first..last are contiguous
                end = segs.get("end")
                if end is not None:
                    data = bytearray()
                    pos = 0
                    while pos < end and pos in segs:
                        data += segs[pos]
                        pos += len(segs[pos])
                    if pos >= end:
                        self.rx_buf[sn] = bytes(data)
                        del self.rx_segs[sn]
            while self.rx_next in self.rx_buf:
                self.deliver(self.rx_buf.pop(self.rx_next))
                self.rx_segs.pop(self.rx_next, None)
                self.rx_next = (self.rx_next + 1) % self.mod
        if poll:
            self.status_due = True

    def tick_reassembly(self):
        """t-Reassembly analog (38.322 §5.2.3.2): when a reception gap
        persists unchanged across consecutive transmission opportunities
        (the lost PDU carried the poll bit, so no poll-triggered STATUS
        will come), trigger a STATUS report."""
        key = (self.rx_next, tuple(sorted(self.rx_buf)),
               tuple(sorted(self.rx_segs)))
        if self.rx_buf or self.rx_segs:
            if getattr(self, "_reassembly_stall", None) == key:
                self.status_due = True
            self._reassembly_stall = key
        else:
            self._reassembly_stall = None

    def _sn_lt(self, a: int, b: int) -> bool:
        return ((a - b) % self.mod) > self.mod // 2

    # --- STATUS PDU (38.322 §6.2.3.10 shape: ACK_SN + NACK_SN list) ---

    def _highest_rx(self) -> int:
        """SN (fully or partially received) farthest ahead of rx_next."""
        return max(set(self.rx_buf) | set(self.rx_segs),
                   key=lambda s: (s - self.rx_next) % self.mod)

    def status_out(self) -> Optional[bytes]:
        if not self.status_due:
            return None
        self.status_due = False
        nacks = self._missing()
        ack_sn = self.rx_next
        if self.rx_buf or self.rx_segs:
            ack_sn = (self._highest_rx() + 1) % self.mod
        out = bytes([0x00]) + ack_sn.to_bytes(3, "big") + \
            len(nacks).to_bytes(2, "big")
        for sn in nacks:
            out += sn.to_bytes(3, "big")
        return out

    def _missing(self):
        """Gap SNs in [rx_next, highest], walked mod-aware so reports
        stay correct across the SN wraparound.  A partially received SN
        (segments outstanding) counts as missing — the per-SN analog of
        the reference's SOstart/SOend NACK ranges."""
        if not self.rx_buf and not self.rx_segs:
            return []
        top = self._highest_rx()
        out = []
        sn = self.rx_next
        while sn != top:
            if sn not in self.rx_buf:
                out.append(sn)
            sn = (sn + 1) % self.mod
        if top not in self.rx_buf:
            out.append(top)
        return out

    def _status_in(self, pdu: bytes):
        ack_sn = int.from_bytes(pdu[1:4], "big")
        n = int.from_bytes(pdu[4:6], "big")
        nacks = {int.from_bytes(pdu[6 + 3 * i: 9 + 3 * i], "big")
                 for i in range(n)}
        sn = self.tx_acked
        while sn != ack_sn:
            if sn not in nacks:
                self.wait_ack.pop(sn, None)
                self.retx_count.pop(sn, None)
            sn = (sn + 1) % self.mod
        for sn in sorted(nacks):
            if sn in self.wait_ack and sn not in self.retx:
                self.retx.append(sn)
        # advance tx_acked past contiguous acked prefix
        while self.tx_acked != self.tx_next and self.tx_acked not in self.wait_ack:
            self.tx_acked = (self.tx_acked + 1) % self.mod
