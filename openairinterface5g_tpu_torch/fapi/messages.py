"""SCF FAPI P5/P7 message subset: typed PDUs + binary pack/unpack.

TPU-native analog of the reference's nFAPI layer
(nfapi/open-nFAPI/nfapi/public_inc/nfapi_nr_interface_scf.h — the
1776-line SCF struct catalogue, and the packing routines in
nfapi/open-nFAPI/nfapi/src).  The wire format here follows the same
shape — a generic message header (message id, length) + SFN/slot, then
per-PDU TLV-free packed bodies like SCF 222 does for P7 — but is a
clean-room compact encoding: little-endian struct packing of exactly the
fields the TPU L1 consumes (models/gnb.py Slot{Dl,Ul}Config).

Message set (ids follow SCF 222 Table 3-5 numbering):
  P5: CONFIG.request (0x02), CONFIG.response (0x03), START.request (0x04),
      STOP.request (0x05)
  P7 DL: DL_TTI.request (0x80), UL_TTI.request (0x81), SLOT.indication
      (0x82), UL_DCI.request (0x83), TX_Data.request (0x84)
  P7 UL: RX_Data.indication (0x85), CRC.indication (0x86),
      UCI.indication (0x87), SRS.indication (0x88), RACH.indication (0x89)

Every message class has .pack() -> bytes and .unpack(buf) classmethods;
the module-level pack_message/unpack_message add the generic header the
PNF/VNF transport (fapi/transport.py) frames over UDP — the process
split of C8 (executables/nr-softmodem.c:684-748 PNF/VNF modes).

A copy of openairinterface5g_tpu/fapi/messages.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import ClassVar

# ---------------------------------------------------------------------------
# generic header
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<HHI")          # message_id, sfn_slot?  -> see below
_MSG_HDR = struct.Struct("<HI")       # message_id, body length


class FapiError(ValueError):
    pass


_REGISTRY: dict[int, type] = {}


def register(cls):
    _REGISTRY[cls.MSG_ID] = cls
    return cls


def pack_message(msg) -> bytes:
    body = msg.pack_body()
    return _MSG_HDR.pack(msg.MSG_ID, len(body)) + body


def unpack_message(buf: bytes):
    if len(buf) < _MSG_HDR.size:
        raise FapiError("short FAPI message")
    mid, ln = _MSG_HDR.unpack_from(buf, 0)
    body = buf[_MSG_HDR.size: _MSG_HDR.size + ln]
    if len(body) != ln:
        raise FapiError(f"truncated FAPI message id=0x{mid:02x}")
    cls = _REGISTRY.get(mid)
    if cls is None:
        raise FapiError(f"unknown FAPI message id 0x{mid:02x}")
    return cls.unpack_body(body)


def _pack_u16s(vals) -> bytes:
    return struct.pack(f"<H{len(vals)}H", len(vals), *vals)


def _unpack_u16s(buf: bytes, off: int):
    (n,) = struct.unpack_from("<H", buf, off)
    vals = list(struct.unpack_from(f"<{n}H", buf, off + 2))
    return vals, off + 2 + 2 * n


# ---------------------------------------------------------------------------
# P5
# ---------------------------------------------------------------------------

@register
@dataclasses.dataclass
class ConfigRequest:
    """CONFIG.request subset (carrier + cell config, SCF 222 §3.3.2)."""
    MSG_ID: ClassVar[int] = 0x02
    _S: ClassVar[struct.Struct] = struct.Struct("<BHHBHB")

    mu: int = 1
    n_bwp_prb: int = 106
    n_cell_id: int = 0
    n_ant_dl: int = 1
    ssb_offset_point_a: int = 0
    n_ant_ul: int = 1

    def pack_body(self) -> bytes:
        return self._S.pack(self.mu, self.n_bwp_prb, self.n_cell_id,
                            self.n_ant_dl, self.ssb_offset_point_a,
                            self.n_ant_ul)

    @classmethod
    def unpack_body(cls, b: bytes):
        return cls(*cls._S.unpack(b))


@register
@dataclasses.dataclass
class ConfigResponse:
    MSG_ID: ClassVar[int] = 0x03
    error_code: int = 0            # 0 = MSG_OK

    def pack_body(self) -> bytes:
        return struct.pack("<B", self.error_code)

    @classmethod
    def unpack_body(cls, b: bytes):
        return cls(*struct.unpack("<B", b))


@register
@dataclasses.dataclass
class StartRequest:
    MSG_ID: ClassVar[int] = 0x04

    def pack_body(self) -> bytes:
        return b""

    @classmethod
    def unpack_body(cls, b: bytes):
        return cls()


@register
@dataclasses.dataclass
class StopRequest:
    MSG_ID: ClassVar[int] = 0x05

    def pack_body(self) -> bytes:
        return b""

    @classmethod
    def unpack_body(cls, b: bytes):
        return cls()


# ---------------------------------------------------------------------------
# P7 PDU bodies
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PdschPdu:
    """nfapi_nr_dl_tti_pdsch_pdu_rel15_t subset (+ rvIndex and the HARQ
    process fields the reference carries in the companion DCI — kept on
    the PDU so the scheduler's HARQ decisions ride the same message)."""
    _S: ClassVar[struct.Struct] = struct.Struct("<HHBBHHBBBBBHBBB")

    rnti: int = 0x1234
    pdu_index: int = 0
    mcs: int = 9
    mcs_table: int = 1
    rb_start: int = 0
    rb_size: int = 106
    start_symbol: int = 0
    nr_of_symbols: int = 14
    n_layers: int = 1
    dmrs_ports: int = 1
    dmrs_max_len: int = 1
    n_id: int = 0
    rv: int = 0
    harq_process_id: int = 0
    new_data: int = 1
    dmrs_symb_pos: tuple = (2,)

    def pack(self) -> bytes:
        return self._S.pack(
            self.rnti, self.pdu_index, self.mcs, self.mcs_table,
            self.rb_start, self.rb_size, self.start_symbol,
            self.nr_of_symbols, self.n_layers, self.dmrs_ports,
            self.dmrs_max_len, self.n_id, self.rv, self.harq_process_id,
            self.new_data) + _pack_u16s(self.dmrs_symb_pos)

    @classmethod
    def unpack(cls, buf: bytes, off: int):
        f = cls._S.unpack_from(buf, off)
        off += cls._S.size
        symb, off = _unpack_u16s(buf, off)
        return cls(*f, dmrs_symb_pos=tuple(symb)), off


@dataclasses.dataclass
class SsbPduMsg:
    """nfapi_nr_dl_tti_ssb_pdu subset."""
    _S: ClassVar[struct.Struct] = struct.Struct("<HHBBI")

    phys_cell_id: int = 0
    prb_offset: int = 0
    start_symbol: int = 2
    ssb_block_index: int = 0
    sfn: int = 0

    def pack(self) -> bytes:
        return self._S.pack(self.phys_cell_id, self.prb_offset,
                            self.start_symbol, self.ssb_block_index, self.sfn)

    @classmethod
    def unpack(cls, buf: bytes, off: int):
        f = cls._S.unpack_from(buf, off)
        return cls(*f), off + cls._S.size


@dataclasses.dataclass
class PdcchPdu:
    """nfapi_nr_dl_dci_pdu_t subset: one DCI on a CORESET."""
    _S: ClassVar[struct.Struct] = struct.Struct("<HHBBHBBB")

    rnti: int = 0x1234
    coreset_prb_start: int = 0
    coreset_n_prb_bundles: int = 6   # CORESET width in REG bundles
    start_symbol: int = 0
    payload_bits: int = 39
    aggregation_level: int = 4
    cce_index: int = 0
    interleaved: int = 0
    payload: bytes = b""

    def pack(self) -> bytes:
        return self._S.pack(
            self.rnti, self.coreset_prb_start, self.coreset_n_prb_bundles,
            self.start_symbol, self.payload_bits, self.aggregation_level,
            self.cce_index, self.interleaved
        ) + struct.pack("<H", len(self.payload)) + self.payload

    @classmethod
    def unpack(cls, buf: bytes, off: int):
        f = cls._S.unpack_from(buf, off)
        off += cls._S.size
        (ln,) = struct.unpack_from("<H", buf, off)
        off += 2
        payload = bytes(buf[off: off + ln])
        return cls(*f, payload=payload), off + ln


@dataclasses.dataclass
class PuschPduMsg:
    """nfapi_nr_pusch_pdu_t subset — maps 1:1 onto models.pusch.PuschConfig."""
    _S: ClassVar[struct.Struct] = struct.Struct("<HHBBHHBBBBHBBB")

    rnti: int = 0x1234
    handle: int = 0
    mcs: int = 9
    mcs_table: int = 1
    rb_start: int = 0
    rb_size: int = 106
    start_symbol: int = 0
    nr_of_symbols: int = 14
    n_layers: int = 1
    transform_precoding: int = 0
    n_id: int = 0
    rv: int = 0
    harq_process_id: int = 0
    new_data: int = 1
    dmrs_symb_pos: tuple = (2,)

    def pack(self) -> bytes:
        return self._S.pack(
            self.rnti, self.handle, self.mcs, self.mcs_table, self.rb_start,
            self.rb_size, self.start_symbol, self.nr_of_symbols,
            self.n_layers, self.transform_precoding, self.n_id, self.rv,
            self.harq_process_id, self.new_data
        ) + _pack_u16s(self.dmrs_symb_pos)

    @classmethod
    def unpack(cls, buf: bytes, off: int):
        f = cls._S.unpack_from(buf, off)
        off += cls._S.size
        symb, off = _unpack_u16s(buf, off)
        return cls(*f, dmrs_symb_pos=tuple(symb)), off


@dataclasses.dataclass
class PucchPduMsg:
    """nfapi_nr_pucch_pdu_t subset (formats 0-4)."""
    _S: ClassVar[struct.Struct] = struct.Struct("<HBHBBBBHHB")

    rnti: int = 0x1234
    format_type: int = 0
    prb_start: int = 0
    start_symbol: int = 12
    nr_of_symbols: int = 2
    initial_cyclic_shift: int = 0
    n_bits: int = 1
    n_id: int = 0
    second_hop_prb: int = 0
    intra_slot_hopping: int = 0

    def pack(self) -> bytes:
        return self._S.pack(self.rnti, self.format_type, self.prb_start,
                            self.start_symbol, self.nr_of_symbols,
                            self.initial_cyclic_shift, self.n_bits,
                            self.n_id, self.second_hop_prb,
                            self.intra_slot_hopping)

    @classmethod
    def unpack(cls, buf: bytes, off: int):
        f = cls._S.unpack_from(buf, off)
        return cls(*f), off + cls._S.size


@dataclasses.dataclass
class PrachPduMsg:
    """nfapi_nr_prach_pdu_t subset."""
    _S: ClassVar[struct.Struct] = struct.Struct("<BHBBHB")

    prach_format: int = 0          # 0-3 long, 4+ = A1..B4 index
    root_sequence_index: int = 0
    num_ra: int = 0                # frequency occasion index
    prach_start_symbol: int = 0
    zero_corr_conf: int = 0
    restricted_set: int = 0

    def pack(self) -> bytes:
        return self._S.pack(self.prach_format, self.root_sequence_index,
                            self.num_ra, self.prach_start_symbol,
                            self.zero_corr_conf, self.restricted_set)

    @classmethod
    def unpack(cls, buf: bytes, off: int):
        f = cls._S.unpack_from(buf, off)
        return cls(*f), off + cls._S.size


def _pack_pdus(pdus) -> bytes:
    out = [struct.pack("<H", len(pdus))]
    out += [p.pack() for p in pdus]
    return b"".join(out)


def _unpack_pdus(cls, buf: bytes, off: int):
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    pdus = []
    for _ in range(n):
        p, off = cls.unpack(buf, off)
        pdus.append(p)
    return pdus, off


# ---------------------------------------------------------------------------
# P7 messages
# ---------------------------------------------------------------------------

@register
@dataclasses.dataclass
class DlTtiRequest:
    """DL_TTI.request (SCF 222 §3.4.2)."""
    MSG_ID: ClassVar[int] = 0x80

    sfn: int = 0
    slot: int = 0
    pdsch: tuple = ()
    ssb: tuple = ()
    pdcch: tuple = ()

    def pack_body(self) -> bytes:
        return (struct.pack("<HH", self.sfn, self.slot)
                + _pack_pdus(self.pdsch) + _pack_pdus(self.ssb)
                + _pack_pdus(self.pdcch))

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot = struct.unpack_from("<HH", b, 0)
        pdsch, off = _unpack_pdus(PdschPdu, b, 4)
        ssb, off = _unpack_pdus(SsbPduMsg, b, off)
        pdcch, off = _unpack_pdus(PdcchPdu, b, off)
        return cls(sfn, slot, tuple(pdsch), tuple(ssb), tuple(pdcch))


@register
@dataclasses.dataclass
class UlTtiRequest:
    """UL_TTI.request (SCF 222 §3.4.3)."""
    MSG_ID: ClassVar[int] = 0x81

    sfn: int = 0
    slot: int = 0
    pusch: tuple = ()
    pucch: tuple = ()
    prach: tuple = ()

    def pack_body(self) -> bytes:
        return (struct.pack("<HH", self.sfn, self.slot)
                + _pack_pdus(self.pusch) + _pack_pdus(self.pucch)
                + _pack_pdus(self.prach))

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot = struct.unpack_from("<HH", b, 0)
        pusch, off = _unpack_pdus(PuschPduMsg, b, 4)
        pucch, off = _unpack_pdus(PucchPduMsg, b, off)
        prach, off = _unpack_pdus(PrachPduMsg, b, off)
        return cls(sfn, slot, tuple(pusch), tuple(pucch), tuple(prach))


@register
@dataclasses.dataclass
class SlotIndication:
    MSG_ID: ClassVar[int] = 0x82
    sfn: int = 0
    slot: int = 0

    def pack_body(self) -> bytes:
        return struct.pack("<HH", self.sfn, self.slot)

    @classmethod
    def unpack_body(cls, b: bytes):
        return cls(*struct.unpack("<HH", b))


@register
@dataclasses.dataclass
class UlDciRequest:
    MSG_ID: ClassVar[int] = 0x83
    sfn: int = 0
    slot: int = 0
    pdcch: tuple = ()

    def pack_body(self) -> bytes:
        return struct.pack("<HH", self.sfn, self.slot) + _pack_pdus(self.pdcch)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot = struct.unpack_from("<HH", b, 0)
        pdcch, _ = _unpack_pdus(PdcchPdu, b, 4)
        return cls(sfn, slot, tuple(pdcch))


@register
@dataclasses.dataclass
class TxDataRequest:
    """TX_Data.request: MAC PDU payloads for the slot's PDSCH PDUs."""
    MSG_ID: ClassVar[int] = 0x84

    sfn: int = 0
    slot: int = 0
    payloads: tuple = ()           # tuple[bytes], index-matched to pdu_index

    def pack_body(self) -> bytes:
        out = [struct.pack("<HHH", self.sfn, self.slot, len(self.payloads))]
        for p in self.payloads:
            out.append(struct.pack("<I", len(p)))
            out.append(p)
        return b"".join(out)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot, n = struct.unpack_from("<HHH", b, 0)
        off = 6
        payloads = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", b, off)
            off += 4
            payloads.append(bytes(b[off: off + ln]))
            off += ln
        return cls(sfn, slot, tuple(payloads))


@register
@dataclasses.dataclass
class RxDataIndication:
    MSG_ID: ClassVar[int] = 0x85
    sfn: int = 0
    slot: int = 0
    pdus: tuple = ()               # tuple[(handle, rnti, payload bytes)]

    def pack_body(self) -> bytes:
        out = [struct.pack("<HHH", self.sfn, self.slot, len(self.pdus))]
        for handle, rnti, payload in self.pdus:
            out.append(struct.pack("<HHI", handle, rnti, len(payload)))
            out.append(payload)
        return b"".join(out)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot, n = struct.unpack_from("<HHH", b, 0)
        off = 6
        pdus = []
        for _ in range(n):
            handle, rnti, ln = struct.unpack_from("<HHI", b, off)
            off += 8
            pdus.append((handle, rnti, bytes(b[off: off + ln])))
            off += ln
        return cls(sfn, slot, tuple(pdus))


@register
@dataclasses.dataclass
class CrcIndication:
    MSG_ID: ClassVar[int] = 0x86
    sfn: int = 0
    slot: int = 0
    crcs: tuple = ()               # tuple[(handle, rnti, harq_id, tb_ok)]

    def pack_body(self) -> bytes:
        out = [struct.pack("<HHH", self.sfn, self.slot, len(self.crcs))]
        for handle, rnti, harq_id, ok in self.crcs:
            out.append(struct.pack("<HHBB", handle, rnti, harq_id, int(ok)))
        return b"".join(out)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot, n = struct.unpack_from("<HHH", b, 0)
        off = 6
        crcs = []
        for _ in range(n):
            handle, rnti, harq_id, ok = struct.unpack_from("<HHBB", b, off)
            off += 6
            crcs.append((handle, rnti, harq_id, bool(ok)))
        return cls(sfn, slot, tuple(crcs))


@register
@dataclasses.dataclass
class UciIndication:
    MSG_ID: ClassVar[int] = 0x87
    sfn: int = 0
    slot: int = 0
    ucis: tuple = ()               # tuple[(rnti, format, bits_as_bytes, ok)]

    def pack_body(self) -> bytes:
        out = [struct.pack("<HHH", self.sfn, self.slot, len(self.ucis))]
        for rnti, fmt, bits, ok in self.ucis:
            out.append(struct.pack("<HBBH", rnti, fmt, int(ok), len(bits)))
            out.append(bits)
        return b"".join(out)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot, n = struct.unpack_from("<HHH", b, 0)
        off = 6
        ucis = []
        for _ in range(n):
            rnti, fmt, ok, ln = struct.unpack_from("<HBBH", b, off)
            off += 6
            ucis.append((rnti, fmt, bytes(b[off: off + ln]), bool(ok)))
            off += ln
        return cls(sfn, slot, tuple(ucis))


@register
@dataclasses.dataclass
class SrsIndication:
    MSG_ID: ClassVar[int] = 0x88
    sfn: int = 0
    slot: int = 0
    reports: tuple = ()            # tuple[(rnti, wideband_snr_db x100 int)]

    def pack_body(self) -> bytes:
        out = [struct.pack("<HHH", self.sfn, self.slot, len(self.reports))]
        for rnti, snr in self.reports:
            out.append(struct.pack("<Hh", rnti, snr))
        return b"".join(out)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot, n = struct.unpack_from("<HHH", b, 0)
        off = 6
        reps = []
        for _ in range(n):
            rnti, snr = struct.unpack_from("<Hh", b, off)
            off += 4
            reps.append((rnti, snr))
        return cls(sfn, slot, tuple(reps))


@register
@dataclasses.dataclass
class RachIndication:
    MSG_ID: ClassVar[int] = 0x89
    sfn: int = 0
    slot: int = 0
    preambles: tuple = ()          # tuple[(preamble_idx, timing_advance, power)]

    def pack_body(self) -> bytes:
        out = [struct.pack("<HHH", self.sfn, self.slot, len(self.preambles))]
        for idx, ta, pw in self.preambles:
            out.append(struct.pack("<HHi", idx, ta, pw))
        return b"".join(out)

    @classmethod
    def unpack_body(cls, b: bytes):
        sfn, slot, n = struct.unpack_from("<HHH", b, 0)
        off = 6
        pre = []
        for _ in range(n):
            idx, ta, pw = struct.unpack_from("<HHi", b, off)
            off += 8
            pre.append((idx, ta, pw))
        return cls(sfn, slot, tuple(pre))


# ---------------------------------------------------------------------------
# PDU <-> PHY config adapters
# ---------------------------------------------------------------------------

def pusch_pdu_to_config(pdu: PuschPduMsg, n_rx: int = 1, n_bwp_prb=None,
                        **overrides):
    """PuschPduMsg -> models.pusch.PuschConfig (the handle_nr_ulsch seam)."""
    from ..models.pusch import PuschConfig
    kw = dict(
        n_prb=pdu.rb_size, mcs=pdu.mcs, mcs_table=pdu.mcs_table,
        n_layers=pdu.n_layers, n_rx=n_rx, start_symbol=pdu.start_symbol,
        n_symbols=pdu.nr_of_symbols, dmrs_symbols=tuple(pdu.dmrs_symb_pos),
        rnti=pdu.rnti, n_id=pdu.n_id,
        transform_precoding=bool(pdu.transform_precoding),
        prb_start=pdu.rb_start, n_bwp_prb=n_bwp_prb,
    )
    kw.update(overrides)
    return PuschConfig(**kw)


def config_to_pusch_pdu(cfg, rv: int = 0, handle: int = 0,
                        harq_id: int = 0, new_data: bool = True) -> PuschPduMsg:
    return PuschPduMsg(
        rnti=cfg.rnti, handle=handle, mcs=cfg.mcs, mcs_table=cfg.mcs_table,
        rb_start=cfg.prb_start, rb_size=cfg.n_prb,
        start_symbol=cfg.start_symbol, nr_of_symbols=cfg.n_symbols,
        n_layers=cfg.n_layers, transform_precoding=int(cfg.transform_precoding),
        n_id=cfg.n_id, rv=rv, harq_process_id=harq_id,
        new_data=int(new_data), dmrs_symb_pos=tuple(cfg.dmrs_symbols))
