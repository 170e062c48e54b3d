"""IF5-analog fronthaul: TIME-domain IQ over UDP (the lower split).

Port of openairinterface5g_tpu/fronthaul/if5.py.  The reference's IF5 split
ships raw time-domain antenna samples between RU and L1 (radio/ETHERNET/,
fh_if5_south_out / north_in in executables/nr-ru.c) — the RU keeps only the
RF; OFDM moves to the L1 host.  Packet format mirrors fronthaul/if4p5.py but
carries sample chunks of the slot waveform instead of per-symbol subcarriers.

Header (little-endian, 24 bytes):
  magic   u32  0x49463500 ("IF5\\0")
  type    u8   0 = UL time-domain, 1 = DL time-domain
  frame   u16
  slot    u8
  chunk   u8   chunk index within the slot
  antenna u8
  n_samp  u16  samples in this chunk
  seq     u32
  scale   f32  int16 block-floating-point scale
  pad     u16
payload: n_samp int16 IQ pairs

The quantization is tensor code on the waveform's device.
``slot_to_packets`` quantizes every CHUNK-sample chunk of an (n_ant, n_samp)
slot in one pass, each chunk scaled by its own max of |re|, |im|; the int16
samples and the scales come to the host in one copy, where the headers are
packed.  ``packets_to_slot`` parses the headers on the host, moves the
payloads and scales to the caller's device in one copy and dequantizes them
there.  The bytes equal the JAX package's: a sample is (x / scale) * 32767 in
float32, rounded half to even and clipped, and the dequantization factor
scale / 32767 is computed in double, then applied in float32 (every division
is by a tensor: PyTorch's CUDA division by a host scalar multiplies by the
reciprocal, which can differ in the last bit).
"""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from ..sim import resolve_device

MAGIC = 0x49463500
_HDR = struct.Struct("<IBHBBBHIfH")
UL_TD = 0
DL_TD = 1
CHUNK = 2048                      # samples per datagram (8 KB payload)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n) complex -> ((..., 2n) int16 interleaved re, im; (...) float32
    scales, each its row's max of |re|, |im|, 1.0 for an all-zero row)."""
    ri = torch.view_as_real(x.to(torch.complex64))
    scale = ri.abs().amax(dim=(-2, -1))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(ri / scale[..., None, None] * 32767).clamp_(-32768, 32767)
    return q.to(torch.int16).reshape(*x.shape[:-1], 2 * x.shape[-1]), scale


@functools.lru_cache(maxsize=8)
def _full_scale(device: torch.device) -> torch.Tensor:
    """32767.0 in float64 on `device`, copied there once."""
    return torch.tensor(32767.0, dtype=torch.float64, device=device)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., 2n) int16 and (...) float32 scales -> (..., n) complex64."""
    f = (scale.double() / _full_scale(scale.device)).float()
    v = q.float().reshape(*q.shape[:-1], -1, 2) * f[..., None, None]
    return torch.view_as_complex(v)


def _with_scales(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int16 samples and the float32 scales as one int16 tensor (the
    scale's bits in the last two entries of each row): one copy moves both."""
    return torch.cat([q, scale.unsqueeze(-1).view(torch.int16)], dim=-1)


def _split_scales(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return buf[..., :-2], np.ascontiguousarray(buf[..., -2:]).view(np.float32)[..., 0]


def pack_chunk(pkt_type: int, frame: int, slot: int, chunk: int,
               antenna: int, seq: int, iq) -> bytes:
    """One chunk of samples (a tensor on any device, or an array) -> one
    datagram."""
    q, scale = _quantize(torch.as_tensor(iq))
    host = _with_scales(q, scale).cpu().numpy()
    q, scale = _split_scales(host)
    return _HDR.pack(MAGIC, pkt_type, frame, slot, chunk, antenna,
                     q.shape[-1] // 2, seq, float(scale), 0) + q.tobytes()


def unpack_chunk(buf: bytes, device: str | torch.device = "cuda"):
    """One datagram -> (type, frame, slot, chunk, antenna, (n,) complex64
    samples on `device`)."""
    (magic, typ, frame, slot, chunk, ant, n, seq, scale,
     _pad) = _HDR.unpack_from(buf, 0)
    assert magic == MAGIC, f"bad IF5 magic {magic:#x}"
    dev = resolve_device(str(device))
    host = np.empty(2 * n + 2, np.int16)
    host[:-2] = np.frombuffer(buf, np.int16, count=2 * n, offset=_HDR.size)
    host[-2:] = np.array([scale], np.float32).view(np.int16)
    t = torch.from_numpy(host).to(dev)
    return typ, frame, slot, chunk, ant, _dequantize(t[:-2], t[-2:].view(torch.float32)[0])


def slot_to_packets(pkt_type: int, frame: int, slot: int,
                    samples, seq0: int = 0) -> list[bytes]:
    """(n_ant, n_samp) waveform (a tensor on any device, or an array) -> list
    of chunked datagrams, antenna by antenna, chunk by chunk."""
    x = torch.as_tensor(samples)
    n_ant, n_samp = x.shape
    n_chunks = -(-n_samp // CHUNK)
    padded = x.new_zeros((n_ant, n_chunks * CHUNK), dtype=torch.complex64)
    padded[:, :n_samp] = x
    q, scale = _quantize(padded.reshape(n_ant, n_chunks, CHUNK))
    q, scale = _split_scales(_with_scales(q, scale).cpu().numpy())   # the slot's one copy
    out = []
    seq = seq0
    for a in range(n_ant):
        for ci in range(n_chunks):
            n = min(CHUNK, n_samp - ci * CHUNK)
            out.append(_HDR.pack(MAGIC, pkt_type, frame, slot, ci, a, n, seq,
                                 float(scale[a, ci]), 0) + q[a, ci, : 2 * n].tobytes())
            seq += 1
    return out


def packets_to_slot(bufs: list[bytes], n_ant: int, n_samp: int,
                    device: str | torch.device = "cuda"
                    ) -> tuple[int, int, int, torch.Tensor]:
    """Reassemble one slot's (n_ant, n_samp) complex64 waveform on `device`
    from its datagrams (any order; a missing chunk stays zero)."""
    dev = resolve_device(str(device))
    n_chunks = -(-n_samp // CHUNK)
    host = np.zeros((n_ant, n_chunks, 2 * CHUNK + 2), np.int16)
    meta = None
    for b in bufs:
        (magic, typ, frame, slot, chunk, ant, n, _seq, scale,
         _pad) = _HDR.unpack_from(b, 0)
        assert magic == MAGIC, f"bad IF5 magic {magic:#x}"
        if meta is None:
            meta = (typ, frame, slot)
        host[ant, chunk, : 2 * n] = np.frombuffer(b, np.int16, count=2 * n, offset=_HDR.size)
        host[ant, chunk, -2:] = np.array([scale], np.float32).view(np.int16)
    t = torch.from_numpy(host).to(dev)                               # the slot's one copy
    wav = _dequantize(t[..., :-2], t[..., -2:].contiguous().view(torch.float32)[..., 0])
    return (*meta, wav.reshape(n_ant, n_chunks * CHUNK)[:, :n_samp])
