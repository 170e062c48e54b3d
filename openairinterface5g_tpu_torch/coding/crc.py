"""3GPP TS 38.212 §5.1 CRC codes as GF(2) matrix products.

Port of openairinterface5g_tpu/coding/crc.py.  A CRC over an A-bit message
is a GF(2) linear map: crc = (bits @ R) mod 2 with the (A, L) remainder
matrix R.  The product runs in float32 (PyTorch has no integer matmul on
CUDA); sums of at most A ones stay exact below 2^24, and the package turns
TF32 off (see ``openairinterface5g_tpu_torch/__init__.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# name -> (L, generator polynomial without the x^L term)
# TS 38.212 §5.1: gCRC24A/B/C, gCRC16, gCRC11, gCRC6
CRC_POLYS: dict[str, tuple[int, int]] = {
    "24A": (24, 0x864CFB),
    "24B": (24, 0x800063),
    "24C": (24, 0xB2B117),
    "16": (16, 0x1021),
    "11": (11, 0x621),
    "6": (6, 0x21),
}


@functools.lru_cache(maxsize=None)
def remainder_matrix(n_bits: int, name: str) -> np.ndarray:
    """(n_bits, L) uint8 matrix M with crc(m) = (m @ M) mod 2.

    Row i is the remainder of x^{n_bits-1-i+L} mod g(x), MSB-first.
    """
    L, poly = CRC_POLYS[name]
    mask = (1 << L) - 1
    out = np.empty((n_bits, L), dtype=np.uint8)
    shifts = np.arange(L - 1, -1, -1)
    r = 1
    for _ in range(L):                      # r = x^L mod g
        r <<= 1
        if r >> L & 1:
            r = (r & mask) ^ poly
    for i in range(n_bits - 1, -1, -1):     # the last message bit first
        out[i] = (r >> shifts) & 1
        r <<= 1
        if r >> L & 1:
            r = (r & mask) ^ poly
    return out


@functools.lru_cache(maxsize=32)
def _remainder_tensor(n_bits: int, name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(remainder_matrix(n_bits, name),
                           dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def mask16(value: int, device: torch.device) -> torch.Tensor:
    """(16,) int8 bits of `value`, MSB first: a CRC16 mask (an RNTI, an
    antenna-count mask)."""
    return torch.tensor([(value >> (15 - i)) & 1 for i in range(16)], dtype=torch.int8,
                        device=device)


def crc_compute(bits: torch.Tensor, name: str) -> torch.Tensor:
    """CRC parity bits for an MSB-first bit array.

    bits: (..., A) in {0,1}.  Returns (..., L) in {0,1}, MSB-first, such that
    concatenating [bits, crc] gives a codeword divisible by g(x).
    """
    M = _remainder_tensor(bits.shape[-1], name, bits.device)
    acc = bits.to(torch.float32) @ M
    return (acc.to(torch.int32) & 1).to(bits.dtype)


def crc_attach(bits: torch.Tensor, name: str) -> torch.Tensor:
    """Append CRC parity to (..., A) bits -> (..., A+L)."""
    return torch.cat([bits, crc_compute(bits, name)], dim=-1)


def crc_ok(bits_with_crc: torch.Tensor, name: str) -> torch.Tensor:
    """Boolean check: the remainder of the (..., A+L) codeword is zero."""
    L, _ = CRC_POLYS[name]
    payload, rx_crc = bits_with_crc[..., :-L], bits_with_crc[..., -L:]
    return torch.all(crc_compute(payload, name) == rx_crc, dim=-1)
