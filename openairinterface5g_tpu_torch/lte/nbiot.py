"""NB-IoT PHY core (TS 36.211 §10): NPSS/NSSS sync, NPBCH, NPDSCH, NPUSCH
and NPRACH, the narrowband companion of the LTE stack.

Port of openairinterface5g_tpu/lte/nbiot.py (the reference's NB-IoT
integration: impl_defs_lte_NB_IoT.h, LTE_TRANSPORT/*_NB_IoT.h).  One 180 kHz
PRB, heavy repetition, tail-biting convolutional (TBCC) downlink and turbo
uplink coding.  Each repetition is one (14, 12) subframe tile on a leading
axis, combined by a mean over it; NPSS and NSSS detection, NSSS
identification and NPRACH detection are one correlation each.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..coding import turbo, viterbi
from ..coding.crc import crc_attach, crc_ok
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence
from . import rate_matching as rm

N_SC = 12

# --------------------------------------------------------------------------
# NPSS (36.211 §10.2.7.1): ZC-11 (u=5) x per-symbol cover, symbols 3..13
# --------------------------------------------------------------------------

_NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], np.float32)


@functools.lru_cache(maxsize=1)
def npss_tile() -> np.ndarray:
    """(11, 11) complex64: symbols 3..13 x subcarriers 0..10."""
    n = np.arange(11)
    zc = np.exp(-1j * np.pi * 5 * n * (n + 1) / 11)
    return (_NPSS_COVER[:, None] * zc[None, :]).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _npss(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(npss_tile(), device=device)


def npss_insert(grid: torch.Tensor) -> torch.Tensor:
    """Add the NPSS onto a (B, 14, 12) subframe-5 tile."""
    out = grid.clone()
    out[:, 3:14, 0:11] += _npss(grid.device)
    return out


def npss_detect(grid: torch.Tensor) -> torch.Tensor:
    """(B, 14, 12) tile -> (B,) correlation metric (normalized 0..1)."""
    t = _npss(grid.device)
    y = grid[:, 3:14, 0:11]
    num = torch.sum(y * torch.conj(t), dim=(1, 2)).abs() ** 2
    den = torch.sum(y.abs() ** 2, dim=(1, 2)) * torch.sum(t.abs() ** 2)
    return num / torch.clamp(den, min=1e-12)


# --------------------------------------------------------------------------
# NSSS (36.211 §10.2.7.2): ZC-131 x Hadamard cover, carries NID + frame pos
# --------------------------------------------------------------------------

_NSSS_THETA = (0, 33, 66, 99)      # cyclic-shift index by (nf/2) mod 4


@functools.lru_cache(maxsize=None)
def _nsss_seq(n_id: int, q_frame: int) -> np.ndarray:
    """(132,) NSSS sequence of cell n_id (0..503) at a frame phase: the ZC
    root u = n_id % 126 + 3, a binary Walsh-style cover b_q (q = n_id // 126:
    the parity of popcount(q m) over the cyclically extended length-128
    index, in the role of Table 10.2.7.2.1-1) and the frame's phase ramp."""
    u = n_id % 126 + 3
    q = n_id // 126
    n = np.arange(132)
    nn = n % 131
    zc = np.exp(-1j * np.pi * u * nn * (nn + 1) / 131)
    bq = np.array([1.0 if bin(q * mm).count("1") % 2 == 0 else -1.0 for mm in n % 128])
    rot = np.exp(-2j * np.pi * _NSSS_THETA[q_frame % 4] * n / 132)
    return (zc * bq * rot).astype(np.complex64)


def nsss_insert(grid: torch.Tensor, n_id: int, q_frame: int) -> torch.Tensor:
    """Add the NSSS (symbols 3..13 x 12 SCs = 132 REs) to a (B, 14, 12) tile."""
    out = grid.clone()
    out[:, 3:14, :] += torch.as_tensor(_nsss_seq(n_id, q_frame), device=grid.device).view(11, 12)
    return out


@functools.lru_cache(maxsize=16)
def _nsss_refs(ids: tuple, q_frame: int, device: torch.device):
    refs = np.stack([_nsss_seq(i, q_frame) for i in ids])               # (N, 132)
    return torch.as_tensor(np.conj(refs).T.copy(), device=device), torch.as_tensor(ids,
                                                                                  device=device)


def nsss_identify(grid: torch.Tensor, n_ids=range(0, 504, 1), q_frame: int = 0):
    """(B, 14, 12) -> (best n_id (B,), metric (B, n_ids)) by one matmul; the
    first id on a tie."""
    refs, ids = _nsss_refs(tuple(n_ids), q_frame, grid.device)
    y = grid[:, 3:14, :].reshape(grid.shape[0], 132)
    corr = (y @ refs).abs() ** 2                                         # (B, N)
    pwr = torch.sum(y.abs() ** 2, dim=-1, keepdim=True) * 132
    metric = corr / torch.clamp(pwr, min=1e-12)
    best = metric == metric.amax(dim=-1, keepdim=True)
    first = torch.where(best, torch.arange(len(ids), device=grid.device), len(ids)).amin(dim=-1)
    return ids[first], metric


# --------------------------------------------------------------------------
# NPBCH (36.211 §10.2.4): MIB-NB, CRC16 + TBCC, QPSK, repetition combining
# --------------------------------------------------------------------------

MIB_NB_BITS = 34
_NPBCH_E = 200                      # coded bits per subframe block (100 REs)


@dataclasses.dataclass(frozen=True)
class NbConfig:
    n_id: int = 0
    n_reps: int = 8                  # subframe repetitions combined


def _npbch_data_re() -> tuple:
    """(sym, sc) of the 100 NPBCH REs: 10 of the 12 SCs on symbols 4..13
    (the CRS/NRS positions of symbols 3..13 simplified away)."""
    sym_ids = np.repeat(np.arange(4, 14), 10)
    sc_ids = np.tile(np.arange(10), 10)
    return sym_ids, sc_ids


def _signs(cinit: int, E: int, device: torch.device) -> torch.Tensor:
    return 1.0 - 2.0 * gold_sequence(cinit, E, device).to(torch.float32)


def npbch_tx(cfg: NbConfig, mib_bits: torch.Tensor) -> torch.Tensor:
    """(B, 34) MIB-NB -> (B, n_reps, 14, 12) repeated subframe tiles."""
    dev = mib_bits.device
    L = MIB_NB_BITS + 16
    d = viterbi.streams(viterbi.encode(crc_attach(mib_bits.to(torch.int8), "16")))
    e = rm.rate_match_tx(d, rm.conv_rm_indices(L, _NPBCH_E))
    syms = mod.modulate(e.to(torch.int8) ^ gold_sequence(cfg.n_id, _NPBCH_E, dev), 2)
    sym_ids, sc_ids = _npbch_data_re()
    tile = torch.zeros((mib_bits.shape[0], 14, 12), dtype=torch.complex64, device=dev)
    tile[:, sym_ids, sc_ids] = syms
    return tile[:, None].expand(-1, cfg.n_reps, 14, 12)


def npbch_rx(cfg: NbConfig, tiles: torch.Tensor) -> dict:
    """(B, n_reps, 14, 12) received tiles -> dict(mib_bits, ok): the mean
    over the repetitions (the coverage-extension gain), then TBCC Viterbi
    and CRC."""
    y = torch.mean(tiles, dim=1)                                         # (B, 14, 12)
    sym_ids, sc_ids = _npbch_data_re()
    syms = y[:, sym_ids, sc_ids]
    lls = llr_mod.llrs(syms, torch.ones_like(syms.real), 2) * _signs(cfg.n_id, _NPBCH_E, y.device)
    L = MIB_NB_BITS + 16
    flat = rm.rate_match_rx(lls, rm.conv_rm_indices(L, _NPBCH_E), 3 * L)
    bits = viterbi.decode(viterbi.triples(flat))
    return {"mib_bits": bits[:, :MIB_NB_BITS], "ok": crc_ok(bits, "16")}


# --------------------------------------------------------------------------
# NPDSCH / NPUSCH: repetition-combined single-PRB data
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NbSchConfig:
    tbs: int = 256                   # from the I_TBS/I_SF tables (36.213)
    n_sf: int = 2                    # subframes per codeword
    n_reps: int = 4                  # repetitions
    n_id: int = 0
    rnti: int = 0x1234
    ul: bool = False                 # False: NPDSCH (TBCC), True: NPUSCH
                                     # (turbo, 36.212 §6.2)

    @property
    def n_re(self) -> int:
        return 11 * N_SC * self.n_sf  # symbols 3..13 per subframe

    @property
    def E(self) -> int:
        return 2 * self.n_re          # QPSK


def _nbsch_cinit(cfg: NbSchConfig) -> int:
    return ((cfg.rnti << 14) + cfg.n_id) % (1 << 31)


def nbsch_tx(cfg: NbSchConfig, tb_bits: torch.Tensor) -> torch.Tensor:
    """(B, TBS) -> (B, n_reps, n_sf, 14, 12) repeated subframe tiles."""
    B, dev = tb_bits.shape[0], tb_bits.device
    with_crc = crc_attach(tb_bits.to(torch.int8), "24A")
    L = cfg.tbs + 24
    if cfg.ul:
        d = torch.cat(turbo.encode(with_crc), dim=-1)
        e = rm.rate_match_tx(d, rm.turbo_rm_indices(L, cfg.E, rv=0))
    else:
        d = viterbi.streams(viterbi.encode(with_crc))
        e = rm.rate_match_tx(d, rm.conv_rm_indices(L, cfg.E))
    syms = mod.modulate(e.to(torch.int8) ^ gold_sequence(_nbsch_cinit(cfg), cfg.E, dev), 2)
    tiles = torch.zeros((B, cfg.n_sf, 14, 12), dtype=torch.complex64, device=dev)
    tiles[:, :, 3:14, :] = syms.view(B, cfg.n_sf, 11, 12)
    return tiles[:, None].expand(B, cfg.n_reps, cfg.n_sf, 14, 12)


def nbsch_rx(cfg: NbSchConfig, tiles: torch.Tensor, n_iters: int = 6) -> dict:
    """(B, n_reps, n_sf, 14, 12) -> dict(tb_bits, ok)."""
    B = tiles.shape[0]
    y = torch.mean(tiles, dim=1)                                         # (B, n_sf, 14, 12)
    syms = y[:, :, 3:14, :].reshape(B, cfg.n_re)
    lls = llr_mod.llrs(syms, torch.ones_like(syms.real), 2) * _signs(_nbsch_cinit(cfg), cfg.E,
                                                                     y.device)
    L = cfg.tbs + 24
    if cfg.ul:
        D = L + 4
        ld = rm.rate_match_rx(lls, rm.turbo_rm_indices(L, cfg.E, rv=0), 3 * D)
        bits, _ = turbo.decode(ld[:, :D], ld[:, D: 2 * D], ld[:, 2 * D:], n_iters=n_iters)
    else:
        flat = rm.rate_match_rx(lls, rm.conv_rm_indices(L, cfg.E), 3 * L)
        bits = viterbi.decode(viterbi.triples(flat))
    return {"tb_bits": bits[:, : cfg.tbs], "ok": crc_ok(bits, "24A")}


# --------------------------------------------------------------------------
# NPRACH (36.211 §10.1.6): single-tone frequency-hopping preamble
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NprachConfig:
    n_sc: int = 12                   # preamble subcarrier space (3.75 kHz
                                     # tones mapped onto one PRB here)
    n_groups: int = 4                # symbol groups per repetition
    n_reps: int = 2


def nprach_hop_pattern(cfg: NprachConfig, n_init: int) -> np.ndarray:
    """(n_reps * n_groups,) tone index per symbol group: the §10.1.6.1 hops
    +1, +6, -1, +6 in the 12-tone space from the initial subcarrier n_init
    (deterministic, so detection can match the whole pattern)."""
    hops, tone = [], n_init
    for g in range(cfg.n_reps * cfg.n_groups):
        hops.append(tone)
        tone = (tone + (1, 6, -1, 6)[g % 4]) % cfg.n_sc
    return np.array(hops, np.int64)


def nprach_tx(cfg: NprachConfig, n_init: int, batch: int = 1,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """-> (B, n_groups_total, n_sc) single-tone symbol groups."""
    hops = nprach_hop_pattern(cfg, n_init)
    out = np.zeros((len(hops), cfg.n_sc), np.complex64)
    out[np.arange(len(hops)), hops] = 1.0
    return torch.as_tensor(out, device=device).expand(batch, *out.shape)


@functools.lru_cache(maxsize=8)
def _nprach_patterns(cfg: NprachConfig, device: torch.device) -> torch.Tensor:
    """(G * n_sc, n_sc) f32: column n0 marks the pattern from tone n0."""
    G = cfg.n_reps * cfg.n_groups
    pats = np.zeros((cfg.n_sc, G, cfg.n_sc), np.float32)
    for n0 in range(cfg.n_sc):
        pats[n0, np.arange(G), nprach_hop_pattern(cfg, n0)] = 1.0
    return torch.as_tensor(pats.reshape(cfg.n_sc, -1).T.copy(), device=device)


def nprach_detect(cfg: NprachConfig, rx: torch.Tensor, threshold: float = 0.3) -> dict:
    """(B, n_groups_total, n_sc) -> dict(detected, n_init, metric): the
    received tone energies against all 12 initial-subcarrier hypotheses in
    one matmul; the first hypothesis on a tie."""
    e = (rx.abs() ** 2).reshape(rx.shape[0], -1)                         # (B, G * n_sc)
    score = e @ _nprach_patterns(cfg, rx.device)                         # (B, n_sc)
    metric = score / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-12)
    peak = metric.amax(dim=-1)
    best = torch.where(metric == peak[:, None], torch.arange(cfg.n_sc, device=rx.device),
                       cfg.n_sc).amin(dim=-1)
    return {"detected": peak > threshold, "n_init": best, "metric": metric}
