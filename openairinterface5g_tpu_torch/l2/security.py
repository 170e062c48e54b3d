"""5G security primitives for PDCP: NEA2 (AES-128-CTR) ciphering and
NIA2 (AES-128-CMAC) integrity, per TS 33.501 / 33.401 Annex B.

The reference uses OpenSSL EVP for these (openair3/SECU/secu_defs.c,
nr_pdcp/nr_pdcp_security_nea2.c, nr_pdcp_integrity_nia2.c).  This is a
dependency-free table-based AES-128 — control/data-plane rates at the
Python L2-lite layer don't need SIMD; the hot PHY path never touches it.

A copy of openairinterface5g_tpu/l2/security.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import struct

# --- AES-128 core (FIPS-197), table-based ---

_SBOX = [
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
]
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36]


def _xtime(a: int) -> int:
    a <<= 1
    if a & 0x100:
        a ^= 0x11b
    return a & 0xFF


def _expand_key(key: bytes) -> list[list[int]]:
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r: 4 * r + 4], []) for r in range(11)]


def _aes_block(rk: list[list[int]], block: bytes) -> bytes:
    s = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]
        # ShiftRows on column-major state: byte i is row i%4, col i//4
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        if rnd < 10:
            t = []
            for c in range(4):
                col = s[4 * c: 4 * c + 4]
                t += [
                    _xtime(col[0]) ^ _xtime(col[1]) ^ col[1] ^ col[2] ^ col[3],
                    col[0] ^ _xtime(col[1]) ^ _xtime(col[2]) ^ col[2] ^ col[3],
                    col[0] ^ col[1] ^ _xtime(col[2]) ^ _xtime(col[3]) ^ col[3],
                    _xtime(col[0]) ^ col[0] ^ col[1] ^ col[2] ^ _xtime(col[3]),
                ]
            s = t
        s = [b ^ k for b, k in zip(s, rk[rnd])]
    return bytes(s)


class Aes128:
    def __init__(self, key: bytes):
        assert len(key) == 16
        self.rk = _expand_key(key)

    def encrypt_block(self, block: bytes) -> bytes:
        return _aes_block(self.rk, block)


# --- NEA2: AES-128-CTR with the 3GPP counter block (33.401 B.1.3) ---

def nea2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """Cipher/decipher (involutive): T_i = AES(CTR_i), out = data ^ T."""
    aes = Aes128(key)
    iv0 = struct.pack(">IB11x", count & 0xFFFFFFFF,
                      ((bearer & 0x1F) << 3) | ((direction & 1) << 2))
    out = bytearray()
    for i in range(0, len(data), 16):
        ctr = (int.from_bytes(iv0, "big") + (i // 16)) & ((1 << 128) - 1)
        ks = aes.encrypt_block(ctr.to_bytes(16, "big"))
        chunk = data[i: i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


# --- NIA2: AES-128-CMAC (RFC 4493) over the 3GPP message (33.401 B.2.3) ---

def _cmac_subkeys(aes: Aes128):
    def dbl(b: bytes) -> bytes:
        n = int.from_bytes(b, "big") << 1
        if b[0] & 0x80:
            n ^= 0x87
        return (n & ((1 << 128) - 1)).to_bytes(16, "big")
    L = aes.encrypt_block(b"\x00" * 16)
    k1 = dbl(L)
    return k1, dbl(k1)


def aes_cmac(key: bytes, msg: bytes) -> bytes:
    aes = Aes128(key)
    k1, k2 = _cmac_subkeys(aes)
    n = max(1, -(-len(msg) // 16))
    last = msg[16 * (n - 1):]
    if len(last) == 16:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        last = last + b"\x80" + b"\x00" * (15 - len(last))
        last = bytes(a ^ b for a, b in zip(last, k2))
    x = b"\x00" * 16
    for i in range(n - 1):
        x = aes.encrypt_block(bytes(a ^ b for a, b in
                                    zip(x, msg[16 * i: 16 * i + 16])))
    return aes.encrypt_block(bytes(a ^ b for a, b in zip(x, last)))


def nia2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """4-byte MAC-I (33.401 B.2.3: CMAC over COUNT|BEARER|DIR|data)."""
    m = struct.pack(">IB3x", count & 0xFFFFFFFF,
                    ((bearer & 0x1F) << 3) | ((direction & 1) << 2)) + data
    return aes_cmac(key, m)[:4]
