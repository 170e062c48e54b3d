"""Small block code (TS 38.212 §5.3.3): (32, K) Reed-Muller for 1..11-bit UCI.

Port of openairinterface5g_tpu/coding/small_block.py.  Encode is a GF(2)
product with the 11 basis sequences of Table 5.3.3.1-1; ML decode
correlates the received LLRs with all 2^K codewords in one (batch, 32) @
(32, 2^K) product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# TS 38.212 Table 5.3.3.1-1 basis sequences M_i,n packed LSB-first per basis
# (bit n of word i = M_{n,i}).
_BASIS_WORDS = (
    0xFFFFFFFF, 0x4BA5A933, 0x7D910E5A, 0x6D26339C, 0x71C7C3E0,
    0x7E0FFC00, 0x731D8E64, 0x6B44F5B0, 0x7DC218EC, 0x4DA1B746, 0x42F0FFFF,
)


@functools.lru_cache(maxsize=1)
def basis_matrix() -> np.ndarray:
    """(11, 32) int8: row i = basis sequence i, bit order n = 0..31."""
    M = np.zeros((11, 32), dtype=np.int8)
    for i, w in enumerate(_BASIS_WORDS):
        for n in range(32):
            M[i, n] = (w >> n) & 1
    return M


@functools.lru_cache(maxsize=16)
def codebook(K: int) -> np.ndarray:
    """(2^K, 32) float32 BPSK codebook (+1 for bit 0) for ML decoding."""
    M = basis_matrix()[:K]
    msgs = ((np.arange(1 << K)[:, None] >> np.arange(K)[None, :]) & 1).astype(np.int8)
    cw = (msgs @ M) & 1
    return (1.0 - 2.0 * cw).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _on(name: str, K: int, device: torch.device) -> torch.Tensor:
    """basis_matrix()[:K] ('basis') or codebook(K).T ('codebook') as float32
    on `device`."""
    a = basis_matrix()[:K] if name == "basis" else codebook(K).T
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)


def encode(bits: torch.Tensor) -> torch.Tensor:
    """(..., K) bits (K <= 11) -> (..., 32) codeword, int8."""
    acc = bits.to(torch.float32) @ _on("basis", bits.shape[-1], bits.device)
    return (acc.to(torch.int32) & 1).to(torch.int8)


def decode(llr: torch.Tensor, K: int, return_conf: bool = False):
    """ML decode (..., 32) LLRs (> 0 = bit 0) -> (..., K) bits, int8.

    With return_conf, also returns the normalized correlation of the best
    codeword (1.0 = every LLR sign matches; ~0 = noise/DTX): the small
    block code has no CRC, so this metric is the only detection signal.
    """
    scores = llr.to(torch.float32) @ _on("codebook", K, llr.device)   # (..., 2^K)
    best = torch.argmax(scores, dim=-1)
    bits = ((best[..., None] >> torch.arange(K, device=llr.device)) & 1).to(torch.int8)
    if not return_conf:
        return bits
    conf = scores.amax(dim=-1) / (llr.to(torch.float32).abs().sum(dim=-1) + 1e-9)
    return bits, conf
