"""O-RAN 7.2x split fronthaul framing analog (eCPRI + section type 1).

Port of openairinterface5g_tpu/fronthaul/oran.py.  The reference's fhi_72
radio (radio/fhi_72/oaioran.c:25) carries the 7.2 split over DPDK/xran:
eCPRI-encapsulated C-plane section headers + U-plane IQ with per-PRB
block-floating-point compression (udCompHdr).  This is the clean-room
framing analog over plain UDP sockets — the packet grammar and BFP
compression, not the DPDK transport:

eCPRI common header (4 bytes, eCPRI spec 3.1.3.1.1):
  byte 0: protocol rev (4b) | reserved (3b) | C=0 (concatenation)
  byte 1: message type (0 = IQ data, 2 = real-time control)
  bytes 2-3: payload size (big-endian)

Application header (8 bytes, O-RAN WG4 CUS 5.4.4 shape):
  pcid/rtcid (2B) | seqid (2B) | frame (1B) | subframe(4b)|slot-hi(4b)
  | slot-lo(2b)|startSym(6b) | numPrb (1B)

Section type 1 U-plane payload per PRB: udCompHdr (1 B: 4b exponent,
4b method=1 BFP) + 12 IQ pairs of `iq_width`-bit mantissas (9-bit
default packed big-endian, as the xran default).

The BFP codec is tensor code over any leading shape of (..., 12) complex
PRBs, on their device (the JAX package loops over each PRB's bits in
Python): the exponent is the least e >= 0 with max|re|, |im| <= 2**e,
capped at 15; a mantissa is round(v / 2**e * (2**(w-1) - 1)) in float64,
half to even, clipped to w-bit two's complement and packed MSB first (27
bytes a PRB at w = 9); decompression is m / (2**(w-1) - 1) * 2**e in
float64, then complex64.  Every division is by a tensor (PyTorch's CUDA
division by a host scalar multiplies by the reciprocal), so the bytes and
the values equal the JAX package's.  ``symbol_to_uplane`` compresses a
symbol's PRBs in one call and ``grid_to_uplane`` a slot grid's, each
cutting its packets from one host copy; ``uplane_to_grid`` rebuilds a slot
grid on the caller's device from one copy.
"""
from __future__ import annotations

import dataclasses
import functools
import struct

import numpy as np
import torch

from ..sim import resolve_device

ECPRI_IQ = 0
ECPRI_RTC = 2
IQ_WIDTH = 9                     # xran default mantissa width


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(2**e for e in 0..15, the mantissa scale 2**(w-1) - 1) in float64 on
    `device`, copied there once."""
    return (torch.tensor([float(1 << e) for e in range(16)], dtype=torch.float64, device=device),
            torch.tensor(float((1 << (width - 1)) - 1), dtype=torch.float64, device=device))


def _prb_bytes(width: int) -> int:
    """Bytes of one compressed PRB: udCompHdr + the packed mantissas."""
    return 1 + (24 * width + 7) // 8


def _bfp_compress(iq: torch.Tensor, width: int = IQ_WIDTH) -> torch.Tensor:
    """(..., 12) complex PRBs -> (..., _prb_bytes(width)) uint8: udCompHdr,
    then the 24 mantissas (re, im interleaved) packed MSB first."""
    dev = iq.device
    lead = iq.shape[:-1]
    flat = torch.view_as_real(iq.to(torch.complex64)).reshape(*lead, 24).double()
    mx = flat.abs().amax(dim=-1)
    m, e = torch.frexp(mx)                    # mx = m * 2**e, m in [0.5, 1); 0 -> (0, 0)
    exp = (e - (m == 0.5).to(e.dtype)).clamp(0, 15).long()
    pow2, _ = _consts(dev, width)
    scale = (1 << (width - 1)) - 1
    q = torch.round(flat / pow2[exp][..., None] * scale).clamp(-(scale + 1), scale).long()
    shifts = torch.arange(width - 1, -1, -1, device=dev)
    bits = ((q[..., None] & ((1 << width) - 1)) >> shifts) & 1       # (..., 24, width)
    bits = bits.reshape(*lead, 24 * width)
    pad = -(24 * width) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros((*lead, pad))], dim=-1)
    weights = torch.arange(7, -1, -1, device=dev)
    payload = (bits.reshape(*lead, -1, 8) << weights).sum(dim=-1)
    return torch.cat([((exp << 4) | 0x1)[..., None], payload], dim=-1).to(torch.uint8)


def _bfp_decompress(raw: torch.Tensor, width: int = IQ_WIDTH) -> torch.Tensor:
    """(..., _prb_bytes(width)) uint8 -> (..., 12) complex64."""
    dev = raw.device
    lead = raw.shape[:-1]
    r = raw.long()
    exp = r[..., 0] >> 4
    bits = (r[..., 1:, None] >> torch.arange(7, -1, -1, device=dev)) & 1
    bits = bits.reshape(*lead, -1)[..., : 24 * width].reshape(*lead, 24, width)
    v = (bits << torch.arange(width - 1, -1, -1, device=dev)).sum(dim=-1)
    v = torch.where(v >= 1 << (width - 1), v - (1 << width), v)
    pow2, scale = _consts(dev, width)
    out = (v.double() / scale * pow2[exp][..., None]).float()
    return torch.view_as_complex(out.reshape(*lead, 12, 2))


def _bfp_compress_prb(iq, width: int = IQ_WIDTH) -> bytes:
    """(12,) complex (a tensor on any device, or an array) -> udCompHdr +
    packed mantissas (O-RAN BFP)."""
    return _bfp_compress(torch.as_tensor(iq), width).cpu().numpy().tobytes()


def _bfp_decompress_prb(buf: bytes, width: int = IQ_WIDTH) -> torch.Tensor:
    """One compressed PRB -> (12,) complex64 on the CPU."""
    return _bfp_decompress(torch.frombuffer(bytearray(buf), dtype=torch.uint8), width)


@dataclasses.dataclass
class OranUPlane:
    pcid: int
    seqid: int
    frame: int
    subframe: int
    slot: int
    start_sym: int
    iq: torch.Tensor              # (n_prb, 12) complex64


def _app_header(pcid: int, seqid: int, frame: int, subframe: int, slot: int,
                start_sym: int, n_prb: int) -> bytes:
    return struct.pack(">HHB", pcid, seqid, frame & 0xFF) + bytes([
        ((subframe & 0xF) << 4) | ((slot >> 2) & 0xF),
        ((slot & 0x3) << 6) | (start_sym & 0x3F),
        n_prb & 0xFF])


def _packet(app: bytes, prbs: np.ndarray) -> bytes:
    """eCPRI header + application header + the compressed PRBs' bytes."""
    body = app + prbs.tobytes()
    return bytes([0x10, ECPRI_IQ]) + struct.pack(">H", len(body)) + body


def pack_uplane(m: OranUPlane) -> bytes:
    iq = torch.as_tensor(m.iq)
    return _packet(_app_header(m.pcid, m.seqid, m.frame, m.subframe, m.slot,
                               m.start_sym, iq.shape[0]),
                   _bfp_compress(iq).cpu().numpy())


def _parse(buf: bytes):
    """(pcid, seqid, frame, subframe, slot, start_sym, n_prb, payload)."""
    rev, typ = buf[0], buf[1]
    assert rev >> 4 == 1 and typ == ECPRI_IQ, (rev, typ)
    (size,) = struct.unpack(">H", buf[2:4])
    body = buf[4: 4 + size]
    pcid, seqid, frame = struct.unpack(">HHB", body[:5])
    subframe = body[5] >> 4
    slot = ((body[5] & 0xF) << 2) | (body[6] >> 6)
    start_sym = body[6] & 0x3F
    n_prb = body[7]
    return pcid, seqid, frame, subframe, slot, start_sym, n_prb, \
        body[8: 8 + n_prb * _prb_bytes(IQ_WIDTH)]


def unpack_uplane(buf: bytes, device: str | torch.device = "cuda") -> OranUPlane:
    """One U-plane packet -> its fields, the PRBs decompressed on `device`."""
    dev = resolve_device(str(device))
    *fields, n_prb, payload = _parse(buf)
    raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    iq = _bfp_decompress(raw.to(dev).reshape(n_prb, _prb_bytes(IQ_WIDTH)))
    return OranUPlane(*fields, iq)


def _cut(pcid: int, seq0: int, frame: int, subframe: int, slot: int, sym: int,
         prbs: np.ndarray, max_prb_per_pkt: int) -> list[bytes]:
    """A symbol's compressed PRBs (n_prb, bytes) on the host -> packets."""
    out = []
    seq = seq0
    for p0 in range(0, prbs.shape[0], max_prb_per_pkt):
        part = prbs[p0: p0 + max_prb_per_pkt]
        out.append(_packet(_app_header(pcid, seq & 0xFFFF, frame, subframe, slot, sym,
                                       part.shape[0]), part))
        seq += 1
    return out


def symbol_to_uplane(pcid: int, seq0: int, frame: int, subframe: int,
                     slot: int, sym: int, re_row,
                     max_prb_per_pkt: int = 64) -> list[bytes]:
    """One OFDM symbol's occupied REs (a tensor on any device, or an array)
    -> eCPRI U-plane datagrams."""
    re_row = torch.as_tensor(re_row)
    n_prb = re_row.shape[-1] // 12
    prbs = _bfp_compress(re_row[: 12 * n_prb].reshape(n_prb, 12)).cpu().numpy()
    return _cut(pcid, seq0, frame, subframe, slot, sym, prbs, max_prb_per_pkt)


def grid_to_uplane(grid: torch.Tensor, frame: int = 0, subframe: int = 0, slot: int = 0,
                   seq0: int = 0, max_prb_per_pkt: int = 64) -> list[bytes]:
    """A slot's (n_ant, n_sym, n_sc) RE grid -> its U-plane datagrams, the
    same as symbol_to_uplane symbol by symbol with pcid = antenna and each
    antenna's seqid counting from seq0; the whole grid is compressed in one
    call and its bytes come to the host in one copy."""
    n_ant, n_sym, n_sc = grid.shape
    n_prb = n_sc // 12
    prbs = _bfp_compress(grid[..., : 12 * n_prb].reshape(n_ant, n_sym, n_prb, 12))
    prbs = prbs.cpu().numpy()
    out = []
    for a in range(n_ant):
        seq = seq0
        for s in range(n_sym):
            pkts = _cut(a, seq, frame, subframe, slot, s, prbs[a, s], max_prb_per_pkt)
            out.extend(pkts)
            seq += len(pkts)
    return out


def uplane_to_grid(bufs: list[bytes], n_ant: int, n_sym: int, n_sc: int,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Rebuild an (n_ant, n_sym, n_sc) complex64 RE grid on `device` (n_sc =
    12 x the PRBs) from a slot's U-plane datagrams in any order (pcid =
    antenna).  The header carries no start PRB, so a symbol's packets are
    placed in seqid order (a seqid that wraps inside a symbol is unwrapped);
    a missing PRB stays zero.  One copy to the device, one decompression."""
    dev = resolve_device(str(device))
    per = _prb_bytes(IQ_WIDTH)
    n_prb = n_sc // 12
    host = np.zeros((n_ant, n_sym, n_prb, per), np.uint8)
    by_symbol: dict[tuple[int, int], list] = {}
    for b in bufs:
        pcid, seqid, _f, _sf, _sl, sym, n, payload = _parse(b)
        by_symbol.setdefault((pcid, sym), []).append((seqid, n, payload))
    for (pcid, sym), parts in by_symbol.items():
        ids = [p[0] for p in parts]
        wrapped = max(ids) - min(ids) > 0x8000
        parts.sort(key=lambda p: p[0] + (0x10000 if wrapped and p[0] < 0x8000 else 0))
        p0 = 0
        for _seq, n, payload in parts:
            host[pcid, sym, p0: p0 + n] = np.frombuffer(payload, np.uint8).reshape(n, per)
            p0 += n
    iq = _bfp_decompress(torch.from_numpy(host).to(dev))             # (n_ant, n_sym, n_prb, 12)
    return iq.reshape(n_ant, n_sym, n_sc)
