"""LTE PBCH (TS 36.211 §6.6, 36.212 §5.3.1).

Port of openairinterface5g_tpu/lte/pbch.py (the reference's pbch.c).  The MIB
(24 bits) and its CRC16 masked by the antenna-count mask, the tail-biting
convolutional code (coding/viterbi.py), rate matching to 1920 bits (normal
CP), scrambling with the cell's Gold sequence over the 40 ms TTI, and QPSK
onto the central 6 PRBs of symbols 7-10 of subframe 0 in four frames.  The
RX soft-combines the four frames and tries the three antenna masks, taking
per row the first whose CRC passes (pbch.c's pbch_detection loop).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..coding import viterbi
from ..coding.crc import crc_attach, crc_ok, mask16
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence
from . import rate_matching as rm
from .params import LteFrameParams, make_lte_frame_params

E_PBCH = 1920                    # normal CP, 4 frames x 480 bits
_ANT_MASK = {1: 0, 2: 0xFFFF, 4: 0x5555}  # 36.212 Table 5.3.1.1-1, MSB-first

_BW_TO_RB = (6, 15, 25, 50, 75, 100)


def mib_pack(n_rb: int, sfn: int, phich_duration: int = 0,
             phich_resource: int = 0) -> np.ndarray:
    """(24,) LTE MIB bits (TS 36.331 MasterInformationBlock): dl-Bandwidth(3),
    phich-duration(1), phich-resource(2), 8 MSBs of the 10-bit SFN, spare(10)."""
    bw = _BW_TO_RB.index(n_rb)
    v = (bw << 21) | (phich_duration << 20) | (phich_resource << 18) \
        | (((sfn >> 2) & 0xFF) << 10)
    return np.array([(v >> (23 - i)) & 1 for i in range(24)], np.int8)


def mib_unpack(bits: np.ndarray) -> dict:
    v = int(sum(int(b) << (23 - i) for i, b in enumerate(np.asarray(bits))))
    return {"n_rb": _BW_TO_RB[(v >> 21) & 7],
            "phich_duration": (v >> 20) & 1,
            "phich_resource": (v >> 18) & 3,
            "sfn_msb8": (v >> 10) & 0xFF}


@dataclasses.dataclass(frozen=True)
class LtePbchConfig:
    n_rb: int = 25
    cell_id: int = 0
    n_tx_ports: int = 1          # antenna-mask hypothesis (1/2/4)
    n_rx: int = 1

    @property
    def fp(self) -> LteFrameParams:
        return make_lte_frame_params(self.n_rb)

    def re_map(self) -> tuple:
        """(sym_ids, sc_ids) of the 240 PBCH REs of one frame (subframe 0,
        symbols 7-10, central 72 SCs; the CRS REs of 4 ports reserved in
        symbols 7/8 whatever the port count)."""
        c0 = self.fp.n_sc // 2 - 36
        vshift = self.cell_id % 6
        sym_ids, sc_ids = [], []
        for s in (7, 8, 9, 10):
            for k in range(72):
                if s in (7, 8) and (c0 + k) % 3 == vshift % 3:
                    continue
                sym_ids.append(s)
                sc_ids.append(c0 + k)
        return np.array(sym_ids), np.array(sc_ids)


def pbch_encode(cfg: LtePbchConfig, mib_bits: torch.Tensor) -> torch.Tensor:
    """(B, 24) MIB -> (B, 1920) scrambled coded bits (one 40 ms TTI)."""
    dev = mib_bits.device
    a = crc_attach(mib_bits.to(torch.int8), "16")
    a[:, 24:] ^= mask16(_ANT_MASK[cfg.n_tx_ports], dev)
    e = rm.rate_match_tx(viterbi.streams(viterbi.encode(a)), rm.conv_rm_indices(40, E_PBCH))
    return e.to(torch.int8) ^ gold_sequence(cfg.cell_id, E_PBCH, dev)


def pbch_tx_grids(cfg: LtePbchConfig, mib_bits: torch.Tensor) -> torch.Tensor:
    """(B, 24) MIB -> (B, 4, 14, n_sc) subframe-0 RE grids of the four frames
    of the TTI (PBCH REs only; the caller adds CRS/PSS/SSS)."""
    syms = mod.modulate(pbch_encode(cfg, mib_bits), 2)                    # (B, 960)
    B, fp = syms.shape[0], cfg.fp
    grids = torch.zeros((B, 4, fp.symbols_per_subframe, fp.n_sc), dtype=torch.complex64,
                        device=mib_bits.device)
    sym_ids, sc_ids = cfg.re_map()
    grids[:, :, sym_ids, sc_ids] = syms.view(B, 4, len(sym_ids))
    return grids


def pbch_decode(cfg: LtePbchConfig, llr_e: torch.Tensor):
    """(B, 1920) descrambled soft bits -> (mib (B, 24), ok (B,), n_ports (B,)).

    Tries each antenna mask; per row, the first whose CRC passes."""
    d_flat = rm.rate_match_rx(llr_e, rm.conv_rm_indices(40, E_PBCH), 120)
    bits = viterbi.decode(viterbi.triples(d_flat))                           # (B, 40)
    B = bits.shape[0]
    best_ok = torch.zeros((B,), dtype=torch.bool, device=bits.device)
    best_ports = torch.zeros((B,), dtype=torch.int32, device=bits.device)
    for ports, mask in _ANT_MASK.items():
        unmasked = bits.clone()
        unmasked[:, 24:] ^= mask16(mask, bits.device)
        ok = crc_ok(unmasked, "16")
        best_ports = torch.where(ok & ~best_ok, ports, best_ports)
        best_ok = best_ok | ok
    return bits[:, :24], best_ok, best_ports


def pbch_rx_grids(cfg: LtePbchConfig, re_grids: torch.Tensor, h: torch.Tensor, nvar=None):
    """(B, 4, R, 14, n_sc) received grids + (B, R, n_sc) channel -> decoded
    (mib, ok, n_ports), soft-combining the four frames."""
    sym_ids, sc_ids = cfg.re_map()
    y = re_grids[..., sym_ids, sc_ids]                                    # (B, 4, R, 240)
    hh = h[:, None, :, sc_ids]
    x = torch.sum(torch.conj(hh) * y, dim=2)                              # (B, 4, 240)
    mag = torch.sum(hh.abs() ** 2, dim=2).expand(x.shape)
    B = x.shape[0]
    lls = llr_mod.llrs(x.reshape(B, -1), mag.reshape(B, -1), 2)
    c = gold_sequence(cfg.cell_id, E_PBCH, lls.device).to(torch.float32)
    return pbch_decode(cfg, lls * (1.0 - 2.0 * c))
