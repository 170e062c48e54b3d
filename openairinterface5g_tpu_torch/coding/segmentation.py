"""TB -> code-block segmentation, TS 38.212 §5.2.2 / §7.2.2.

Port of openairinterface5g_tpu/coding/segmentation.py: host-side parameter
derivation plus the tensor bit plumbing.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.tables import ALL_LIFTING_SIZES, BG_KCB

from .crc import crc_attach


@dataclasses.dataclass(frozen=True)
class SegmentParams:
    bg: int
    B: int          # TB bits incl. TB CRC
    C: int          # number of code blocks
    K_prime: int    # info bits per CB incl. CB CRC (before filler)
    K: int          # CB size after filler padding (= kc * Z)
    Z: int          # lifting size
    F: int          # filler bits per CB
    Kb: int

    @property
    def cb_crc(self) -> bool:
        return self.C > 1


def base_graph_select(A: int, rate: float) -> int:
    """TS 38.212 §7.2.2 base-graph selection from TB size A and code rate."""
    if A <= 292 or (A <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


def segment_params(B: int, bg: int) -> SegmentParams:
    Kcb = BG_KCB[bg]
    if B <= Kcb:
        C, B_prime = 1, B
    else:
        C = -(-B // (Kcb - 24))
        B_prime = B + C * 24
    if B_prime % C:
        raise ValueError(f"B'={B_prime} not divisible by C={C}")
    K_prime = B_prime // C
    if bg == 1:
        Kb = 22
    else:
        Kb = 10 if B > 640 else 9 if B > 560 else 8 if B > 192 else 6
    Z = min(z for z in ALL_LIFTING_SIZES if Kb * z >= K_prime)
    K = (22 if bg == 1 else 10) * Z
    return SegmentParams(bg=bg, B=B, C=C, K_prime=K_prime, K=K, Z=Z,
                         F=K - K_prime, Kb=Kb)


def _data_per_cb(p: SegmentParams) -> int:
    return p.K_prime - (24 if p.cb_crc else 0)


def segment_tb(tb_with_crc: torch.Tensor, p: SegmentParams) -> torch.Tensor:
    """Split (..., B) TB bits into (..., C, K) code blocks.

    Appends the per-CB CRC24B when C > 1 and zero filler bits up to K (the
    decoder treats fillers as known zeros).
    """
    lead = tb_with_crc.shape[:-1]
    cbs = tb_with_crc.reshape(*lead, p.C, _data_per_cb(p))
    if p.cb_crc:
        cbs = crc_attach(cbs, "24B")
    if p.F:
        pad = cbs.new_zeros((*lead, p.C, p.F))
        cbs = torch.cat([cbs, pad], dim=-1)
    return cbs


def desegment_tb(cbs: torch.Tensor, p: SegmentParams) -> torch.Tensor:
    """Inverse of segment_tb: (..., C, K) decoded bits -> (..., B) TB bits."""
    n = _data_per_cb(p)
    return cbs[..., :n].reshape(*cbs.shape[:-2], p.C * n)
