"""PBCH / SSB chain: PSS/SSS/PBCH generation + UE RX.

Port of openairinterface5g_tpu/models/pbch.py.  The SSB is a static
240-subcarrier x 4-symbol tile (mapping per TS 38.211 §7.4.3.1); the payload
interleaving and both scrambling levels follow TS 38.212 §7.1 and TS 38.211
§7.3.3.1.  The MIB's pack/unpack and the burst patterns (TS 38.213 §4.1) are
host functions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..coding import polar
from ..coding.crc import crc_attach
from ..phy import refsig
from ..phy.channel_estimation import freq_average, ls_estimate
from ..phy.llr import llrs as llr_compute
from ..phy.modulation import modulate
from ..phy.scrambling import gold_sequence

# TS 38.212 §7.1.1 PBCH payload interleaving pattern G(j)
PBCH_PAYLOAD_INTERLEAVER = np.array(
    [16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
     9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31],
    dtype=np.int32,
)


def _payload_ilv() -> np.ndarray:
    """ILV[src] = destination bit: the §7.1.1 class-based interleaver
    (j_SFN = 0, j_HRF = 10, j_SSB = 11, j_other = 14 walk G(j))."""
    G = PBCH_PAYLOAD_INTERLEAVER
    ilv = np.zeros(32, np.int64)
    j_sfn, j_hrf, j_ssb, j_other = 0, 10, 11, 14
    for i in range(32):
        if i == 0 or 7 <= i < 24:       # choice bit, other MIB bits
            ilv[i] = G[j_other]
            j_other += 1
        elif i < 7 or 24 <= i < 28:     # 6 SFN MSBs, 4 SFN LSBs
            ilv[i] = G[j_sfn]
            j_sfn += 1
        elif i == 28:                   # half-frame bit
            ilv[i] = G[j_hrf]
        else:                           # SSB index / k_SSB MSB bits
            ilv[i] = G[j_ssb]
            j_ssb += 1
    return ilv


_ILV = _payload_ilv()                       # src -> dest
_ILV_INV = np.argsort(_ILV)                 # dest -> src (gather indices)
# interleaved-domain positions exempt from 1st-level scrambling (HRF + 2nd/3rd
# SFN LSBs; + 3 SSB-index bits at Lmax = 64)
_EXEMPT = {8: (0, 6, 24), 64: (0, 2, 3, 5, 6, 24)}

A_PBCH = 32           # payload bits
E_PBCH = 864
K_PBCH = 56           # A + CRC24
N_SSB_SC = 240


@dataclasses.dataclass(frozen=True)
class PbchConfig:
    n_id: int = 0           # physical cell id (0..1007)
    i_ssb: int = 0          # SSB (candidate) index, 0..Lmax-1
    n_hf: int = 0
    lmax: int = 8           # max SSBs per burst (4 / 8 / 64)

    @property
    def v(self) -> int:
        return self.n_id % 4

    @property
    def i_ssb_eff(self) -> int:
        """DMRS scrambling index (TS 38.211 7.4.1.4.1): Lmax = 4 uses the 2
        LSBs + 4*n_hf; Lmax > 4 the 3 LSBs of the SSB index."""
        if self.lmax == 4:
            return (self.i_ssb & 3) + 4 * self.n_hf
        return self.i_ssb & 7

    @property
    def v2(self) -> int:
        """2nd-level scrambling shift (38.211 7.3.3.1): 2 or 3 SSB-index LSBs
        depending on Lmax."""
        return self.i_ssb & 3 if self.lmax == 4 else self.i_ssb & 7


def _polar_params():
    return polar.polar_params(K=K_PBCH, E=E_PBCH, n_max=9, i_il=True)


def _dmrs_cinit(cfg: PbchConfig) -> int:
    """TS 38.211 §7.4.1.4.1 PBCH DMRS cinit."""
    return ((1 << 11) * (cfg.i_ssb_eff + 1) * (cfg.n_id // 4 + 1)
            + (1 << 6) * (cfg.i_ssb_eff + 1) + (cfg.n_id % 4)) % (1 << 31)


def pbch_dmrs(cfg: PbchConfig, device: torch.device | str = "cpu") -> torch.Tensor:
    """(144,) QPSK DMRS sequence (TS 38.211 §7.4.1.4)."""
    return refsig.dmrs_sequence(_dmrs_cinit(cfg), 144, torch.device(device))


def _dmrs_positions(cfg: PbchConfig):
    """(sym, sc) positions of the 144 PBCH DMRS REs within the SSB tile."""
    v = cfg.v
    pos = [(1, v + k) for k in range(0, 240, 4)]
    pos += [(2, v + k) for k in range(0, 48, 4)]
    pos += [(2, v + k) for k in range(192, 240, 4)]
    pos += [(3, v + k) for k in range(0, 240, 4)]
    return np.array(pos, dtype=np.int32)


def _data_positions(cfg: PbchConfig):
    """(sym, sc) positions of the 432 PBCH data REs (TS 38.211 7.4.3.1-1)."""
    v = cfg.v
    pos = [(1, k) for k in range(240) if k % 4 != v]
    pos += [(2, k) for k in list(range(48)) + list(range(192, 240)) if k % 4 != v]
    pos += [(3, k) for k in range(240) if k % 4 != v]
    return np.array(pos, dtype=np.int32)


def _first_level_masks(lmax: int):
    exempt = _EXEMPT[64 if lmax == 64 else 8]
    scr_pos = np.array([i for i in range(32) if i not in exempt], np.int64)
    return scr_pos, len(scr_pos)


def _first_level_sequence(cfg: PbchConfig, a_ilv: torch.Tensor) -> torch.Tensor:
    """(B, 32) interleaved payload -> (B, 32) 1st-level scrambling bits (0 at
    the exempt positions): Gold seeded by the cell id at offset v*M, v =
    2*(3rd SFN LSB) + (2nd SFN LSB), both read from the (unscrambled)
    interleaved payload, so one function scrambles and descrambles."""
    scr_pos, M = _first_level_masks(cfg.lmax)
    dev = a_ilv.device
    v = 2 * a_ilv[..., 6].long() + a_ilv[..., 24].long()            # (B,) in 0..3
    c = gold_sequence(cfg.n_id, 4 * M, dev)
    idx = v[..., None] * M + torch.arange(M, device=dev)
    s = torch.zeros(a_ilv.shape, dtype=torch.int8, device=dev)
    s[..., torch.as_tensor(scr_pos, device=dev)] = c[idx].to(torch.int8)
    return s


def _second_level(cfg: PbchConfig, device: torch.device) -> torch.Tensor:
    v = cfg.v2
    return gold_sequence(cfg.n_id, (v + 1) * E_PBCH, device)[v * E_PBCH:]


def pbch_encode(cfg: PbchConfig, payload: torch.Tensor) -> torch.Tensor:
    """(B, 32) payload (MIB + extra bits, see mib_payload) -> (B, 864)
    scrambled coded bits: class-based payload interleaving, the SFN-seeded
    1st-level scrambling, CRC24C, polar (K = 56, E = 864), the 2nd-level
    scrambling (shift = SSB-index LSBs)."""
    dev = payload.device
    a_ilv = payload[..., torch.as_tensor(_ILV_INV, device=dev)].to(torch.int8)
    a_prime = a_ilv ^ _first_level_sequence(cfg, a_ilv)
    e = polar.encode(_polar_params(), crc_attach(a_prime, "24C"))
    return e ^ _second_level(cfg, dev)


def pbch_decode(cfg: PbchConfig, llr_e: torch.Tensor, list_size: int = 8):
    """(B, 864) LLRs -> ((B, 32) payload, ok (B,)): 2nd-level descramble,
    SCL decode + CRC24C, 1st-level descramble (v from the exempt SFN bits),
    payload deinterleave."""
    c = _second_level(cfg, llr_e.device)
    llr_d = llr_e * (1.0 - 2.0 * c.to(llr_e.dtype))
    a_prime, ok = polar.decode_with_crc(_polar_params(), llr_d, "24C", list_size=list_size)
    a_ilv = a_prime ^ _first_level_sequence(cfg, a_prime)
    return a_ilv[..., torch.as_tensor(_ILV, device=llr_e.device)], ok


@functools.lru_cache(maxsize=32)
def _tile_consts(cfg: PbchConfig, device: torch.device):
    """The tile's constants on `device`: PSS, SSS, data and DMRS positions
    (symbol, sc), the DMRS, and for the receiver the DMRS REs of each comb-4
    SC (in SC order, with their weights and count) and the nearest comb SC
    of each data RE."""
    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    mpos, dpos = _dmrs_positions(cfg), _data_positions(cfg)
    pos_of = {}
    for i, (_, k) in enumerate(mpos):
        pos_of.setdefault(int(k), []).append(i)
    scs = sorted(pos_of)
    h_map = np.abs(dpos[:, 1][None, :] - np.array(scs)[:, None]).argmin(axis=0)
    # each comb SC's 2 or 3 DMRS REs, padded to 3 with a zero weight
    group = np.array([(pos_of[k] * 2)[:3] for k in scs])
    weight = np.array([[1, 1, len(pos_of[k]) == 3] for k in scs], np.float32)
    return {
        "pss": on(refsig.pss_sequence(cfg.n_id % 3), torch.complex64),
        "sss": on(refsig.sss_sequence(cfg.n_id // 3, cfg.n_id % 3), torch.complex64),
        "d_sym": on(dpos[:, 0], torch.long), "d_sc": on(dpos[:, 1], torch.long),
        "m_sym": on(mpos[:, 0], torch.long), "m_sc": on(mpos[:, 1], torch.long),
        "dmrs": pbch_dmrs(cfg, device),
        "group": on(group, torch.long), "weight": on(weight),
        "count": on([len(pos_of[k]) for k in scs], torch.float32),
        "h_map": on(h_map, torch.long),
    }


def ssb_generate(cfg: PbchConfig, payload: torch.Tensor) -> torch.Tensor:
    """(B, 32) payload -> (B, 4, 240) SSB tile (PSS + SSS + PBCH + DMRS)."""
    B, dev = payload.shape[0], payload.device
    k = _tile_consts(cfg, dev)
    grid = torch.zeros((B, 4, N_SSB_SC), dtype=torch.complex64, device=dev)
    grid[:, 0, 56:183] = k["pss"]
    grid[:, 2, 56:183] = k["sss"]
    grid[:, k["d_sym"], k["d_sc"]] = modulate(pbch_encode(cfg, payload), 2)   # (B, 432)
    grid[:, k["m_sym"], k["m_sc"]] = k["dmrs"]
    return grid


def ssb_receive(cfg: PbchConfig, rx_tile: torch.Tensor, list_size: int = 8):
    """(B, n_rx, 4, 240) received SSB tile -> (decoded payload, CRC flag).

    DMRS LS estimation; block fading over the 4 symbols: the LS estimates
    of the symbols sharing each comb-4 SC averaged (symbols 1/3 carry all
    60, symbol 2 the outer 24), smoothed in frequency (window 16); each data
    RE takes its nearest comb SC; MRC, QPSK LLRs, polar SCL decode.
    """
    k = _tile_consts(cfg, rx_tile.device)
    hp = ls_estimate(rx_tile[:, :, k["m_sym"], k["m_sc"]], k["dmrs"])     # (B, R, 144)
    means = torch.sum(hp[..., k["group"]] * k["weight"], dim=-1) / k["count"]   # (B, R, 60)
    h_data = freq_average(means, window=16)[..., k["h_map"]]               # (B, R, 432)
    yd = rx_tile[:, :, k["d_sym"], k["d_sc"]]
    x = torch.sum(torch.conj(h_data) * yd, dim=1)      # MRC over the antennas
    mag = torch.sum(h_data.abs() ** 2, dim=1)
    return pbch_decode(cfg, llr_compute(x, mag, 2), list_size=list_size)


# --------------------------------------------------------------------------
# MIB payload pack/unpack (TS 38.331 MIB + TS 38.212 §7.1.1 extra bits)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mib:
    """BCCH-BCH MIB fields (TS 38.331).  sfn/hrf/ssb index live outside."""

    scs_common: int = 1          # 0: 15/60 kHz, 1: 30/120 kHz
    k_ssb: int = 0               # ssb-SubcarrierOffset, 5 bits (MSB via extra)
    dmrs_typea_pos: int = 0      # 0: pos2, 1: pos3
    pdcch_config_sib1: int = 0   # 8 bits
    cell_barred: int = 0
    intra_freq_reselection: int = 0


def mib_payload(mib: Mib, sfn: int, hrf: int = 0, ssb_idx: int = 0,
                lmax: int = 8) -> np.ndarray:
    """-> (32,) int8 PBCH payload a_0..a_31 (pre-interleave order): 24 MIB
    bits MSB-first (choice bit, 6 SFN MSBs, scs, 4 k_SSB LSBs, dmrs pos,
    pdcch cfg, barred, reselection, spare), then 4 SFN LSBs, HRF, and 3
    SSB-index MSBs (Lmax = 64) / the k_SSB MSB (else)."""
    a = np.zeros(32, np.int8)
    for i in range(6):
        a[1 + i] = (sfn >> (9 - i)) & 1
    a[7] = mib.scs_common & 1
    for i in range(4):
        a[8 + i] = (mib.k_ssb >> (3 - i)) & 1
    a[12] = mib.dmrs_typea_pos & 1
    for i in range(8):
        a[13 + i] = (mib.pdcch_config_sib1 >> (7 - i)) & 1
    a[21] = mib.cell_barred & 1
    a[22] = mib.intra_freq_reselection & 1
    for i in range(4):
        a[24 + i] = (sfn >> (3 - i)) & 1
    a[28] = hrf & 1
    if lmax == 64:
        for i in range(3):
            a[29 + i] = (ssb_idx >> (5 - i)) & 1
    else:
        a[29] = (mib.k_ssb >> 4) & 1
    return a


def mib_unpack(payload, lmax: int = 8) -> dict:
    """(..., 32) decoded payload -> dict of MIB + timing fields (tensors)."""
    a = torch.as_tensor(payload).to(torch.int64)

    def num(sl):
        bits = a[..., sl]
        w = 2 ** torch.arange(bits.shape[-1] - 1, -1, -1, device=a.device)
        return torch.sum(bits * w, dim=-1)

    out = {
        "sfn": num(slice(1, 7)) * 16 + num(slice(24, 28)),
        "scs_common": a[..., 7],
        "dmrs_typea_pos": a[..., 12],
        "pdcch_config_sib1": num(slice(13, 21)),
        "cell_barred": a[..., 21],
        "intra_freq_reselection": a[..., 22],
        "hrf": a[..., 28],
    }
    if lmax == 64:
        out["k_ssb"] = num(slice(8, 12))
        out["ssb_idx_msbs"] = num(slice(29, 32)) * 8  # add the PBCH DMRS index
    else:
        out["k_ssb"] = a[..., 29] * 16 + num(slice(8, 12))
    return out


# --------------------------------------------------------------------------
# SSB burst timing (TS 38.213 §4.1 cases A-E)
# --------------------------------------------------------------------------

def ssb_first_symbols(case: str, lmax: int) -> np.ndarray:
    """Candidate SSB first-symbol indices (within the half frame, counted in
    the SSB numerology's symbols) for burst case A..E."""
    case = case.upper()
    if case in ("A", "C"):
        base, step = np.array([2, 8]), 14
        n = {4: range(2), 8: range(4)}[lmax]
    elif case == "B":
        base, step = np.array([4, 8, 16, 20]), 28
        n = {4: range(1), 8: range(2)}[lmax]
    elif case == "D":
        base, step = np.array([4, 8, 16, 20]), 28
        if lmax != 64:
            raise ValueError("case D takes Lmax = 64")
        n = [i for i in range(19) if i % 5 != 4]     # 0..18 minus 4,9,14
    elif case == "E":
        base, step = np.array([8, 12, 16, 20, 32, 36, 40, 44]), 56
        if lmax != 64:
            raise ValueError("case E takes Lmax = 64")
        n = [i for i in range(9) if i != 4]
    else:
        raise ValueError(f"unknown SSB case {case!r}")
    out = np.concatenate([base + step * i for i in n])
    assert len(out) == lmax, (case, lmax, len(out))
    return out.astype(np.int64)


def ssb_in_slot(case: str, lmax: int, slot: int,
                symbols_per_slot: int = 14) -> list[tuple[int, int]]:
    """[(ssb_idx, start_symbol_in_slot)] for the SSB candidates landing in
    `slot` (counted in the SSB numerology)."""
    firsts = ssb_first_symbols(case, lmax)
    lo, hi = slot * symbols_per_slot, (slot + 1) * symbols_per_slot
    return [(int(i), int(s - lo)) for i, s in enumerate(firsts) if lo <= s and s + 4 <= hi]
