"""LTE code block segmentation (TS 36.212 §5.1.2).

Port of openairinterface5g_tpu/lte/segmentation.py (lte_segmentation.c).
The turbo block size is the smallest QPP table K that fits B'/C, possibly
two sizes K-/K+ (the first c_minus blocks short); the F filler bits lead
block 0 and are sent as <NULL> (rate matching skips them).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..coding.crc import crc_attach
from ..data.lte_tables import QPP_BY_K

Z_MAX = 6144
_K_TABLE = np.array(sorted(QPP_BY_K.keys()), np.int64)


@dataclasses.dataclass(frozen=True)
class LteSegParams:
    B: int          # input bits incl. TB CRC
    C: int          # number of code blocks
    c_minus: int    # blocks of size k_minus (the first c_minus blocks)
    k_minus: int
    k_plus: int
    F: int          # filler bits (start of block 0)

    @property
    def block_sizes(self) -> tuple:
        return (self.k_minus,) * self.c_minus + (self.k_plus,) * (self.C - self.c_minus)

    @property
    def cb_crc(self) -> bool:
        return self.C > 1


@functools.lru_cache(maxsize=64)
def segment_params(B: int) -> LteSegParams:
    if B <= Z_MAX:
        L, C, Bp = 0, 1, B
    else:
        L = 24
        C = -(-B // (Z_MAX - L))
        Bp = B + C * L
    k_plus = int(_K_TABLE[np.searchsorted(_K_TABLE, -(-Bp // C))])
    if C == 1:
        k_minus, c_minus = 0, 0
    else:
        k_minus = int(_K_TABLE[np.searchsorted(_K_TABLE, k_plus) - 1])
        c_minus = (C * k_plus - Bp) // (k_plus - k_minus)
    F = (C - c_minus) * k_plus + c_minus * k_minus - Bp
    return LteSegParams(B=B, C=C, c_minus=c_minus, k_minus=k_minus, k_plus=k_plus, F=F)


def _groups(p: LteSegParams):
    """[(K, count, contains_block0)] in transmission order."""
    out = []
    if p.c_minus:
        out.append((p.k_minus, p.c_minus, True))
    out.append((p.k_plus, p.C - p.c_minus, p.c_minus == 0))
    return out


def segment_tb(tb_with_crc: torch.Tensor, p: LteSegParams) -> list:
    """(batch, B) bits -> one (batch, C_g, K_g) tensor per size group: [K-]
    then K+.  With C > 1 each block gets CRC24B; block 0 starts with F
    filler zeros."""
    B = tb_with_crc.shape[0]
    L = 24 if p.C > 1 else 0
    groups, pos = [], 0
    for K, cnt, first in _groups(p):
        blocks = []
        for r in range(cnt):
            lead = p.F if (first and r == 0) else 0
            take = K - L - lead
            blk = tb_with_crc[:, pos: pos + take]
            if lead:
                blk = torch.cat([blk.new_zeros((B, lead)), blk], dim=-1)
            pos += take
            if L:
                blk = crc_attach(blk.to(torch.int8), "24B")
            blocks.append(blk)
        groups.append(torch.stack(blocks, dim=1))
    return groups


def desegment_tb(groups: list, p: LteSegParams) -> torch.Tensor:
    """Inverse of segment_tb: decoded blocks -> (batch, B) TB (with its CRC)."""
    L = 24 if p.C > 1 else 0
    parts = []
    for (K, cnt, first), blocks in zip(_groups(p), groups):
        for r in range(cnt):
            lead = p.F if (first and r == 0) else 0
            parts.append(blocks[:, r, lead: K - L])
    return torch.cat(parts, dim=-1)
