"""Gold-sequence scrambling (TS 38.211 §5.2.1).

Port of openairinterface5g_tpu/phy/scrambling.py.  The two LFSRs are GF(2)
linear maps: x1 does not depend on cinit and is a host constant; x2 at
output block b is A^(Nc+31b) applied to the cinit state, so every 31-bit
block is one masked parity of cinit.  Every cinit the port uses is a
configuration constant, so the sequence is built on the host and cached on
the device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

NC = 1600


def _advance_matrix(taps: tuple[int, ...]) -> np.ndarray:
    """31x31 GF(2) one-step matrix for s_i' = x(n+1+i): shift + feedback."""
    A = np.zeros((31, 31), dtype=np.uint8)
    for i in range(30):
        A[i, i + 1] = 1
    for t in taps:
        A[30, t] ^= 1
    return A


def _matmul_gf2(A, B):
    return ((A.astype(np.uint32) @ B.astype(np.uint32)) & 1).astype(np.uint8)


def _matpow_gf2(A, p):
    R = np.eye(31, dtype=np.uint8)
    while p:
        if p & 1:
            R = _matmul_gf2(R, A)
        A = _matmul_gf2(A, A)
        p >>= 1
    return R


def _pack_rows(M: np.ndarray) -> np.ndarray:
    """(31,31) GF(2) matrix -> (31,) uint32 packed rows (bit j = M[i,j])."""
    return (M.astype(np.uint64) << np.arange(31, dtype=np.uint64)).sum(axis=1).astype(np.uint32)


def _parity32(x: np.ndarray) -> np.ndarray:
    """Parity of each uint32 (xor-fold; independent of numpy's popcount)."""
    x = x ^ (x >> np.uint32(16))
    x = x ^ (x >> np.uint32(8))
    x = x ^ (x >> np.uint32(4))
    x = x ^ (x >> np.uint32(2))
    x = x ^ (x >> np.uint32(1))
    return (x & np.uint32(1)).astype(np.int8)


@functools.lru_cache(maxsize=64)
def _gold_tables(length: int):
    """Host tables: x1 bits (n_blocks*31,) and packed x2 block matrices."""
    n_blocks = -(-length // 31)
    x1 = np.zeros(NC + n_blocks * 31 + 31, dtype=np.uint8)
    x1[0] = 1
    for n in range(len(x1) - 31):          # x1(n+31) = x1(n+3) + x1(n)
        x1[n + 31] = x1[n + 3] ^ x1[n]
    A2 = _advance_matrix((0, 1, 2, 3))     # x2(n+31) = x2(n+3)+x2(n+2)+x2(n+1)+x2(n)
    Apow = np.empty((n_blocks, 31), dtype=np.uint32)
    M = _matpow_gf2(A2, NC)
    step = _matpow_gf2(A2, 31)
    for b in range(n_blocks):
        Apow[b] = _pack_rows(M)
        M = _matmul_gf2(step, M)
    return x1[NC: NC + n_blocks * 31].astype(np.int8), Apow


def gold_sequence_np(cinit: int, length: int) -> np.ndarray:
    """c(n) for n in [0, length) as int8 {0,1}, for a static cinit."""
    x1, Apow = _gold_tables(length)
    x2 = _parity32(Apow & np.uint32(cinit)).reshape(-1)[:length]
    return x1[:length] ^ x2


@functools.lru_cache(maxsize=32)
def gold_sequence(cinit: int, length: int, device: torch.device) -> torch.Tensor:
    """c(n) as an int8 tensor on `device` (cached per cinit, length)."""
    return torch.as_tensor(gold_sequence_np(int(cinit), length), device=device)


def scramble(bits: torch.Tensor, cinit: int) -> torch.Tensor:
    """(Un)scramble a bit tensor: out = bits XOR c.  Involutive."""
    return bits ^ gold_sequence(cinit, bits.shape[-1], bits.device).to(bits.dtype)


def scramble_llrs(llrs: torch.Tensor, cinit: int) -> torch.Tensor:
    """Descramble soft values: flip the LLR sign where c(n) = 1."""
    c = gold_sequence(cinit, llrs.shape[-1], llrs.device)
    return llrs * (1.0 - 2.0 * c.to(llrs.dtype))


def pusch_cinit(rnti: int, q: int, n_id: int) -> int:
    """TS 38.211 §6.3.1.1 data scrambling cinit (uint32 arithmetic)."""
    return ((int(rnti) << 15) + (q << 14) + n_id) & 0xFFFFFFFF


def pdsch_cinit(rnti: int, q: int, n_id: int) -> int:
    """TS 38.211 §7.3.1.1 data scrambling cinit (uint32 arithmetic)."""
    return ((int(rnti) << 15) + (q << 14) + n_id) & 0xFFFFFFFF
