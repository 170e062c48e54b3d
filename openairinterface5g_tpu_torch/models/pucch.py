"""PUCCH formats 0-4: UCI TX + gNB RX.

Port of openairinterface5g_tpu/models/pucch.py.

Format 0: sequence selection — a length-12 low-PAPR sequence cyclically
shifted by the UCI value; detection correlates against every candidate
shift.  Format 1: sequence-modulated BPSK/QPSK with time-domain OCC.
Format 2: UCI bits -> small block (<= 11 bits) or CRC + polar (>= 12) ->
QPSK over N PRBs with comb DMRS; RX = LS estimate + MRC + LLR + decode.
Formats 3/4: DFT-s-OFDM — coded UCI scrambled, QPSK (or pi/2-BPSK), format 4
adds the pre-DFT block-wise OCC (SF 2/4), DFT spread over Msc = 12*n_prb,
low-PAPR DMRS symbols; the RX inverts with the shared despreader.

Every table (sequences per symbol, OCC, pilots) is a host constant of the
configuration, kept on the device once per (configuration, device).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..coding import polar, small_block
from ..coding.crc import CRC_POLYS, crc_attach
from ..data.tables import _load_npz
from ..phy import refsig
from ..phy.channel_estimation import freq_average, ls_estimate
from ..phy.hopping import _gold_bits_host, group_sequence_uv
from ..phy.llr import llrs as llr_compute
from ..phy.modulation import modulate
from ..phy.scrambling import gold_sequence, gold_sequence_np, scramble_llrs
from ..phy.transform_precoding import dft_spread, idft_despread


def _on(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Low-PAPR sequences (TS 38.211 §5.2.2)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def low_papr_base(u: int, m_zc: int = 12) -> np.ndarray:
    """r_u(n) = exp(j*phi(n)*pi/4) for M_ZC in {6,12,18,24}."""
    phi = _load_npz()[f"phi{m_zc}"][u]
    return np.exp(1j * phi.astype(np.float64) * np.pi / 4).astype(np.complex64)


def cyclic_shifted(u: int, alpha_idx: int, m_zc: int = 12) -> np.ndarray:
    """r_{u,alpha}(n) = e^{j*2*pi*alpha_idx*n/m_zc} r_u(n)."""
    base = low_papr_base(u, m_zc)
    n = np.arange(m_zc)
    return (np.exp(2j * np.pi * alpha_idx * n / m_zc) * base).astype(np.complex64)


# --------------------------------------------------------------------------
# Per-symbol hopping state (shared by formats 0/1)
# --------------------------------------------------------------------------

def _ncs_symbol(hopping_id: int, slot: int, symbol: int, symbols_per_slot: int = 14) -> int:
    """n_cs(n_s, l) — TS 38.211 §6.3.2.2.2: 8 Gold bits per (slot, symbol)
    seeded by the hopping id."""
    off = 8 * (symbols_per_slot * slot + symbol)
    c = _gold_bits_host(hopping_id, off + 8).astype(np.int64)
    return int((c[off: off + 8] * (1 << np.arange(8))).sum())


def _symbol_states(cfg) -> list[tuple[int, int, int]]:
    """Per PUCCH symbol: (u, n_cs, hop).  Intra-slot frequency hopping
    splits the symbols at floor(N/2) (TS 38.211 §6.3.2.4.1); group /
    sequence hopping gives each hop its own sequence group u."""
    states = []
    n_first = cfg.n_symbols // 2 if cfg.intra_slot_hopping else cfg.n_symbols
    for i in range(cfg.n_symbols):
        hop = 1 if (cfg.intra_slot_hopping and i >= n_first) else 0
        u, _ = group_sequence_uv(cfg.hopping_id, cfg.group_hopping, cfg.slot, hop)
        ncs = _ncs_symbol(cfg.hopping_id, cfg.slot, cfg.start_symbol + i)
        states.append((u, ncs, hop))
    return states


# --------------------------------------------------------------------------
# Format 0
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pucch0Config:
    n_bits: int = 1             # 1 or 2 HARQ-ACK bits
    initial_cs: int = 0
    hopping_id: int = 0
    n_symbols: int = 1
    start_symbol: int = 13
    slot: int = 0
    group_hopping: str = "neither"   # 'neither' | 'enable' | 'disable'
    intra_slot_hopping: bool = False
    second_hop_prb: int = 0          # PRB of the 2nd hop (grid mapper use)

    @property
    def shifts(self) -> tuple:
        """m_cs per UCI value (TS 38.213 Table 9.2.3-3/-4)."""
        return (0, 6) if self.n_bits == 1 else (0, 3, 6, 9)


def _f0_candidate_table(cfg: Pucch0Config) -> np.ndarray:
    """(n_symbols, 12, 12): candidate sequence per (symbol, m_cs) with the
    per-symbol alpha = 2pi/12 * (m0 + m_cs + n_cs(ns,l)) mod 12 and the
    per-hop sequence group u (TS 38.211 §6.3.2.2.2)."""
    out = np.empty((cfg.n_symbols, 12, 12), np.complex64)
    for i, (u, ncs, _) in enumerate(_symbol_states(cfg)):
        for m in range(12):
            out[i, m] = cyclic_shifted(u, (cfg.initial_cs + m + ncs) % 12)
    return out


@functools.lru_cache(maxsize=32)
def _f0_tables(cfg: Pucch0Config, device: torch.device):
    """(the TX table (12, S, 12) by m_cs, m_cs per UCI value, the RX's
    conjugated candidates (S, n_cand, 12)) on `device`."""
    full = _f0_candidate_table(cfg)
    return (_on(full.transpose(1, 0, 2), device), _on(cfg.shifts, device, torch.long),
            _on(np.conj(full[:, np.array(cfg.shifts)]), device))


def pucch0_tx(cfg: Pucch0Config, uci: torch.Tensor) -> torch.Tensor:
    """(B,) UCI values -> (B, n_symbols, 12) sequence symbols."""
    table, shifts, _ = _f0_tables(cfg, uci.device)
    return table[shifts[uci.long()] % 12]


def pucch0_rx(cfg: Pucch0Config, rx: torch.Tensor):
    """(B, n_rx, n_symbols, 12) received REs -> (uci (B,), energy (B, n_cand)):
    correlation against every candidate shift, coherent per symbol; the
    per-candidate energies double as a DTX statistic."""
    table = _f0_tables(cfg, rx.device)[2]
    corr = torch.einsum("brsk,sck->brsc", rx, table)
    energy = torch.sum(corr.abs() ** 2, dim=(1, 2))          # (B, n_cand)
    return torch.argmax(energy, dim=-1), energy


# --------------------------------------------------------------------------
# Format 2
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pucch2Config:
    n_bits: int = 4
    n_prb: int = 4
    n_symbols: int = 1
    start_symbol: int = 13
    rnti: int = 0x1234
    n_id: int = 0       # scrambling id
    n_id0: int = 0      # DMRS scrambling

    @property
    def data_sc_per_prb(self) -> int:
        return 8  # DMRS on SCs 1,4,7,10 per PRB (38.211 6.4.1.3.2.2)

    @property
    def E(self) -> int:
        return self.data_sc_per_prb * self.n_prb * self.n_symbols * 2  # QPSK


def _pucch2_positions(cfg: Pucch2Config):
    sc = np.arange(12 * cfg.n_prb)
    return sc[sc % 3 != 1].astype(np.int32), sc[sc % 3 == 1].astype(np.int32)


def _uci_code(n_bits: int, E: int):
    """(CRC name, polar parameters) of a >= 12-bit UCI payload: CRC6 and 3 PC
    bits below 20 bits, CRC11 from 20 (TS 38.212 §6.3.1.2-3)."""
    crc_name = "11" if n_bits >= 20 else "6"
    n_pc = 0 if n_bits >= 20 else 3
    K = n_bits + CRC_POLYS[crc_name][0]
    return crc_name, polar.polar_params(K=K, E=E, n_max=10, i_il=False, n_pc=n_pc, i_bil=True)


def uci_encode(n_bits: int, E: int, uci: torch.Tensor) -> torch.Tensor:
    """(B, n_bits) -> (B, E) coded UCI bits (TS 38.212 §6.3.1.3).

    <= 11 bits: small block (RM 32,K) circularly repeated to E;
    >= 12: CRC6/11 + polar with i_bil interleaving.
    """
    if n_bits <= 11:
        cw = small_block.encode(uci)
        return cw.repeat(1, -(-E // 32))[:, :E]
    crc_name, p = _uci_code(n_bits, E)
    return polar.encode(p, crc_attach(uci.to(torch.int8), crc_name))


def uci_decode(n_bits: int, E: int, llr: torch.Tensor, list_size: int = 8):
    """(B, E) LLRs -> (uci (B, n_bits), ok (B,)); inverse of uci_encode.
    The small block code has no CRC: its 'ok' is a correlation confidence
    above 0.5 (the fraction of the LLR mass agreeing with the best
    codeword), so a caller can detect DTX or a failed decode."""
    if n_bits <= 11:
        B = llr.shape[0]
        pad = (-E) % 32
        full = torch.cat([llr, llr.new_zeros((B, pad))], dim=-1) if pad else llr
        folded = full.reshape(B, -1, 32).sum(dim=1)    # repetitions add
        uci, conf = small_block.decode(folded, n_bits, return_conf=True)
        return uci, conf > 0.5
    crc_name, p = _uci_code(n_bits, E)
    return polar.decode_with_crc(p, llr, crc_name, list_size=list_size)


def pucch2_encode(cfg: Pucch2Config, uci: torch.Tensor) -> torch.Tensor:
    """(B, n_bits) -> (B, E) coded bits (small block or polar+CRC)."""
    return uci_encode(cfg.n_bits, cfg.E, uci)


@functools.lru_cache(maxsize=32)
def _f2_consts(cfg: Pucch2Config, device: torch.device):
    """(data SCs, DMRS SCs, (S, P) pilots per symbol, nearest pilot per data
    SC) on `device`."""
    data_sc, dmrs_sc = _pucch2_positions(cfg)
    pil = np.stack([refsig.dmrs_sequence_np(refsig.dmrs_cinit(0, cfg.start_symbol + s, cfg.n_id0),
                                            len(dmrs_sc)) for s in range(cfg.n_symbols)])
    nearest = np.abs(data_sc[None, :] - dmrs_sc[:, None]).argmin(axis=0)
    return (_on(data_sc, device, torch.long), _on(dmrs_sc, device, torch.long),
            _on(pil, device), _on(nearest, device, torch.long))


def pucch2_tx(cfg: Pucch2Config, uci: torch.Tensor) -> torch.Tensor:
    """(B, n_bits) UCI -> (B, n_symbols, 12*n_prb) REs (data + DMRS)."""
    B, dev = uci.shape[0], uci.device
    bits = pucch2_encode(cfg, uci)
    c = gold_sequence((cfg.rnti << 15) + cfg.n_id, cfg.E, dev)
    syms = modulate(bits ^ c, 2).reshape(B, cfg.n_symbols, -1)
    data_sc, dmrs_sc, pil, _ = _f2_consts(cfg, dev)
    grid = torch.zeros((B, cfg.n_symbols, 12 * cfg.n_prb), dtype=torch.complex64, device=dev)
    grid[:, :, data_sc] = syms
    grid[:, :, dmrs_sc] = pil
    return grid


def pucch2_rx(cfg: Pucch2Config, rx: torch.Tensor, list_size: int = 8):
    """(B, n_rx, n_symbols, 12*n_prb) -> (uci (B, n_bits), ok (B,)).

    ok is a CRC flag for the polar path and the correlation confidence of
    the small-block path.  Per symbol: LS at the DMRS, pilot smoothing
    (window 8, ~2 PRB, where more than 2 pilots), nearest-pilot mapping.
    """
    data_sc, dmrs_sc, pil, nearest = _f2_consts(cfg, rx.device)
    hs = []
    for s in range(cfg.n_symbols):
        hp = ls_estimate(rx[:, :, s][..., dmrs_sc], pil[s])      # (B, R, P)
        if len(dmrs_sc) > 2:
            hp = freq_average(hp, window=min(8, len(dmrs_sc)))
        hs.append(hp[..., nearest])
    h = torch.stack(hs, dim=2)                                    # (B, R, S, D)
    yd = rx[..., data_sc]
    x = torch.sum(torch.conj(h) * yd, dim=1)
    mag = torch.sum(h.abs() ** 2, dim=1)
    B = x.shape[0]
    llr = llr_compute(x.reshape(B, -1), mag.reshape(B, -1), 2)
    llr = scramble_llrs(llr, (cfg.rnti << 15) + cfg.n_id)
    return uci_decode(cfg.n_bits, cfg.E, llr, list_size=list_size)


# --------------------------------------------------------------------------
# Format 1 (TS 38.211 §6.3.2.4): sequence-modulated with time-domain OCC
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pucch1Config:
    n_bits: int = 1             # 1 (BPSK) or 2 (QPSK)
    n_symbols: int = 14         # 4..14
    start_symbol: int = 0
    initial_cs: int = 0
    hopping_id: int = 0
    occ_index: int = 0          # time-domain OCC row
    slot: int = 0
    group_hopping: str = "neither"
    intra_slot_hopping: bool = False
    second_hop_prb: int = 0

    @property
    def n_data_syms(self) -> int:
        return self.n_symbols // 2

    @property
    def n_dmrs_syms(self) -> int:
        return self.n_symbols - self.n_data_syms

    def occ_blocks(self) -> list[tuple[list[int], list[int]]]:
        """[(dmrs_symbol_idxs, data_symbol_idxs)] per intra-slot hop — the
        time-domain OCC spans each hop separately (TS 38.211 Table
        6.3.2.4.1-1)."""
        n_first = self.n_symbols // 2 if self.intra_slot_hopping else self.n_symbols
        out = []
        for h in (range(0, n_first), range(n_first, self.n_symbols)):
            syms = list(h)
            if syms:
                out.append(([s for s in syms if s % 2 == 0], [s for s in syms if s % 2 == 1]))
        return out


def _occ_matrix(n: int) -> np.ndarray:
    """DFT orthogonal cover codes w_i(m) = exp(j 2 pi i m / n)."""
    i = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return np.exp(2j * np.pi * i * m / n).astype(np.complex64)


def _f1_bases(cfg: Pucch1Config) -> np.ndarray:
    """(n_symbols, 12) per-symbol base sequence r_{u,alpha(l)} with the
    per-symbol alpha (m0 + n_cs(ns,l)) and per-hop group u."""
    out = np.empty((cfg.n_symbols, 12), np.complex64)
    for i, (u, ncs, _) in enumerate(_symbol_states(cfg)):
        out[i] = cyclic_shifted(u, (cfg.initial_cs + ncs) % 12)
    return out


@functools.lru_cache(maxsize=32)
def _f1_tx_tables(cfg: Pucch1Config, device: torch.device):
    """(the BPSK/QPSK points (2^n_bits,), (S, 12) DMRS symbol values with
    their OCC (zero on data symbols), (S, 12) data symbols' sequence x OCC)."""
    bases = _f1_bases(cfg)
    pts = np.array([1 + 0j, -1 + 0j] if cfg.n_bits == 1 else
                   [(1 + 1j), (1 - 1j), (-1 + 1j), (-1 - 1j)], dtype=np.complex64)
    pts = pts / (np.sqrt(2) if cfg.n_bits == 2 else 1)
    dm = np.zeros((cfg.n_symbols, 12), np.complex64)
    da = np.zeros((cfg.n_symbols, 12), np.complex64)
    for dmrs_syms, data_syms in cfg.occ_blocks():
        w_m = _occ_matrix(len(dmrs_syms))[cfg.occ_index]
        for mi, s in enumerate(dmrs_syms):
            dm[s] = bases[s] * w_m[mi]
        if data_syms:
            w_d = _occ_matrix(len(data_syms))[cfg.occ_index]
            for di, s in enumerate(data_syms):
                da[s] = bases[s] * w_d[di]
    return _on(pts.astype(np.complex64), device), _on(dm, device), _on(da, device)


def pucch1_tx(cfg: Pucch1Config, uci: torch.Tensor) -> torch.Tensor:
    """(B,) UCI values -> (B, n_symbols, 12) REs.

    DMRS on even symbol offsets, data on odd (38.211 Table 6.4.1.3.1.3-1
    structure); data symbol = d * r_alpha(l) * w_occ(m), the OCC spanning
    each intra-slot hop separately.
    """
    pts, dm, da = _f1_tx_tables(cfg, uci.device)
    d = pts[uci.long()]
    return dm[None] + d[:, None, None] * da[None]


@functools.lru_cache(maxsize=32)
def _f1_rx_tables(cfg: Pucch1Config, device: torch.device):
    """Per hop with data: (DMRS symbols, data symbols, the conjugated
    sequence x OCC of each, (n, 12))."""
    bases_c = np.conj(_f1_bases(cfg))
    out = []
    for dmrs_syms, data_syms in cfg.occ_blocks():
        if not data_syms:
            continue
        w_m = np.conj(_occ_matrix(len(dmrs_syms))[cfg.occ_index])
        w_d = np.conj(_occ_matrix(len(data_syms))[cfg.occ_index])
        out.append((_on(dmrs_syms, device, torch.long), _on(data_syms, device, torch.long),
                    _on((bases_c[dmrs_syms] * w_m[:, None]).astype(np.complex64), device),
                    _on((bases_c[data_syms] * w_d[:, None]).astype(np.complex64), device)))
    return out


def pucch1_rx(cfg: Pucch1Config, rx: torch.Tensor):
    """(B, n_rx, n_symbols, 12) -> (uci (B,), |correlation| (B,)).

    Coherent detection: the channel from the DMRS symbols (OCC-despread),
    the data symbols OCC-despread and matched against the constellation;
    the hops are detected separately and combined.
    """
    corr = None
    for dm_s, da_s, dm_w, da_w in _f1_rx_tables(cfg, rx.device):
        h = torch.mean(rx[:, :, dm_s] * dm_w, dim=2)           # (B, R, 12)
        z = torch.mean(rx[:, :, da_s] * da_w, dim=2)
        c = torch.sum(torch.conj(h) * z, dim=(1, 2))            # (B,)
        corr = c if corr is None else corr + c
    b0 = (corr.real < 0).to(torch.int64)
    uci = b0 if cfg.n_bits == 1 else 2 * b0 + (corr.imag < 0).to(torch.int64)
    return uci, corr.abs()


def hopped_group(hopping_id: int, slot: int, n_symbols_half: int = 2,
                 enabled: bool = True) -> int:
    """Group hopping (TS 38.211 §6.3.2.2.1): u = (f_gh + f_ss) mod 30, f_gh
    from the Gold sequence seeded floor(n_id/30), 8 bits per hop index (the
    slot here: intra-slot hopping off)."""
    f_ss = hopping_id % 30
    if not enabled:
        return f_ss
    c = gold_sequence_np(hopping_id // 30, 8 * (2 * slot + 2)).astype(np.int64)
    seg = c[8 * 2 * slot: 8 * 2 * slot + 8]
    f_gh = int((seg * (1 << np.arange(8))).sum() % 30)
    return (f_gh + f_ss) % 30


# --------------------------------------------------------------------------
# Formats 3 / 4 (TS 38.211 §6.3.2.6): DFT-s-OFDM UCI
# --------------------------------------------------------------------------

# DMRS symbol positions, TS 38.211 Table 6.4.1.3.3.2-1 (no intra-slot
# frequency hopping).  additional_dmrs applies for lengths >= 10.
_F34_DMRS = {
    4: [1], 5: [0, 3], 6: [1, 4], 7: [1, 4], 8: [1, 5], 9: [1, 6],
    10: [2, 7], 11: [2, 7], 12: [2, 8], 13: [2, 9], 14: [3, 10],
}
_F34_DMRS_ADD = {
    10: [1, 3, 6, 8], 11: [1, 3, 6, 9], 12: [1, 4, 7, 10],
    13: [1, 4, 7, 11], 14: [1, 5, 8, 12],
}


def _f4_occ(sf: int, n: int) -> np.ndarray:
    """Format 4 pre-DFT block-wise OCC (TS 38.211 Table 6.3.2.6.3-1/-2):
    the phase pattern over the 12 subcarriers, blocks of Msc/SF."""
    block = np.arange(12) // (12 // sf)
    return np.exp(2j * np.pi * n * block / sf).astype(np.complex64)


# Format 4 DMRS initial cyclic shift per OCC index (TS 38.211 Table
# 6.4.1.3.3.1-1)
_F4_DMRS_CS = {2: (0, 6), 4: (0, 6, 3, 9)}


@dataclasses.dataclass(frozen=True)
class Pucch34Config:
    fmt: int = 3                 # 3 or 4
    n_bits: int = 16
    n_prb: int = 1               # format 3: 1..16 (2^a 3^b 5^c); format 4: 1
    n_symbols: int = 14          # 4..14
    start_symbol: int = 0
    rnti: int = 0x1234
    n_id: int = 0
    hopping_id: int = 0
    pi2_bpsk: bool = False
    additional_dmrs: bool = False
    occ_len: int = 2             # format 4 only: 2 or 4
    occ_index: int = 0

    def __post_init__(self):
        if self.fmt == 4 and not (self.n_prb == 1 and self.occ_len in (2, 4)):
            raise ValueError("format 4 takes 1 PRB and an OCC of length 2 or 4")

    @property
    def msc(self) -> int:
        return 12 * self.n_prb

    @property
    def dmrs_symbols(self) -> tuple:
        tab = _F34_DMRS_ADD if (self.additional_dmrs and self.n_symbols >= 10) else _F34_DMRS
        return tuple(tab[self.n_symbols])

    @property
    def data_symbols(self) -> tuple:
        d = set(self.dmrs_symbols)
        return tuple(s for s in range(self.n_symbols) if s not in d)

    @property
    def qm(self) -> int:
        return 1 if self.pi2_bpsk else 2

    @property
    def E(self) -> int:
        sf = self.occ_len if self.fmt == 4 else 1
        return len(self.data_symbols) * (self.msc // sf) * self.qm


def _pi2_rotation(E: int) -> np.ndarray:
    """pi/2-BPSK's rotation of symbol i (TS 38.211 §5.1.1)."""
    i = np.arange(E)
    return (np.exp(1j * np.pi / 2 * (i % 2)).astype(np.complex64)
            * np.complex64((1 + 1j) / 2 ** 0.5))


def _modulate_f34(cfg: Pucch34Config, bits: torch.Tensor) -> torch.Tensor:
    """QPSK or pi/2-BPSK mapping of (B, E) bits."""
    if not cfg.pi2_bpsk:
        return modulate(bits, 2)
    rot = _on(_pi2_rotation(bits.shape[-1]), bits.device)
    return (1.0 - 2.0 * bits.to(torch.float32)) * rot[None, :]


def _f34_dmrs_seq(cfg: Pucch34Config) -> np.ndarray:
    """Low-PAPR DMRS base sequence for one symbol (group from hopping_id)."""
    u = cfg.hopping_id % 30
    if cfg.msc <= 24:
        base = cyclic_shifted(u, 0, cfg.msc)
    else:
        base = refsig.low_papr_sequence(u, 0, cfg.msc)
    if cfg.fmt == 4:
        m0 = _F4_DMRS_CS[cfg.occ_len][cfg.occ_index]
        base = base * np.exp(2j * np.pi * m0 * np.arange(cfg.msc) / 12)
    return base.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _f34_consts(cfg: Pucch34Config, device: torch.device):
    """(DMRS pilots (msc,), data symbols, DMRS symbols, the F4 OCC (12,) or
    None, the F4 delay window (12,) or None) on `device`."""
    occ = window = None
    if cfg.fmt == 4:
        occ = _on(_f4_occ(cfg.occ_len, cfg.occ_index), device)
        # users multiplexed on the PRB sit at distinct DMRS cyclic shifts =
        # distinct delay taps: keep the delays around this user's own tap
        half = (12 // len(_F4_DMRS_CS[cfg.occ_len]) - 1) // 2
        d = np.arange(12)
        window = _on((np.minimum(d, 12 - d) <= half).astype(np.float32), device)
    return (_on(_f34_dmrs_seq(cfg), device), _on(cfg.data_symbols, device, torch.long),
            _on(cfg.dmrs_symbols, device, torch.long), occ, window)


def pucch34_tx(cfg: Pucch34Config, uci: torch.Tensor) -> torch.Tensor:
    """(B, n_bits) UCI -> (B, n_symbols, msc) frequency-domain REs: encode,
    scramble, modulate, (F4) block-OCC spread, DFT, plus the low-PAPR DMRS
    symbols."""
    B, dev = uci.shape[0], uci.device
    pil, data_s, dmrs_s, occ, _ = _f34_consts(cfg, dev)
    bits = uci_encode(cfg.n_bits, cfg.E, uci)
    c = gold_sequence((cfg.rnti << 15) + cfg.n_id, cfg.E, dev)
    d = _modulate_f34(cfg, bits ^ c)                     # (B, n_data*msc/sf)
    n_data = len(cfg.data_symbols)
    if cfg.fmt == 4:
        sf = cfg.occ_len
        d = d.reshape(B, n_data, cfg.msc // sf).repeat(1, 1, sf) * occ
        d = d.reshape(B, n_data * cfg.msc)
    y = dft_spread(d, cfg.msc).reshape(B, n_data, cfg.msc)
    grid = torch.zeros((B, cfg.n_symbols, cfg.msc), dtype=torch.complex64, device=dev)
    grid[:, data_s] = y
    grid[:, dmrs_s] = pil
    return grid


def pucch34_rx(cfg: Pucch34Config, rx: torch.Tensor, list_size: int = 8):
    """(B, n_rx, n_symbols, msc) -> (uci (B, n_bits), ok (B,)).

    LS channel estimate averaged over the DMRS symbols, MRC matched filter,
    the shared IDFT despreader (per-RE ZF + harmonic-mean gain), (F4) OCC
    despread/fold, max-log LLRs, descramble, small-block/polar decode.
    """
    B = rx.shape[0]
    pil, data_s, dmrs_s, occ, window = _f34_consts(cfg, rx.device)
    h = torch.mean(rx[:, :, dmrs_s] * torch.conj(pil), dim=2)     # (B, R, msc)
    if cfg.fmt == 4:
        h = torch.fft.fft(torch.fft.ifft(h, dim=-1) * window, dim=-1).to(torch.complex64)
    yd = rx[:, :, data_s]                                           # (B, R, S, msc)
    x = torch.sum(torch.conj(h)[:, :, None, :] * yd, dim=1)         # (B, S, msc)
    mag = torch.sum(h.abs() ** 2, dim=1)[:, None, :].expand(x.shape)
    n_data = len(cfg.data_symbols)
    d, mag_eff = idft_despread(x.reshape(B, -1), mag.reshape(B, -1), cfg.msc)
    if cfg.fmt == 4:
        sf = cfg.occ_len
        d = (d.reshape(B, n_data, sf, cfg.msc // sf)
             * torch.conj(occ).reshape(1, 1, sf, cfg.msc // sf)).sum(dim=2).reshape(B, -1)
        mag_eff = mag_eff.reshape(B, n_data, sf, cfg.msc // sf).sum(dim=2).reshape(B, -1)
    if cfg.pi2_bpsk:
        derot = np.conj(_pi2_rotation(d.shape[-1]))
        llr = (d * _on(derot, d.device)[None, :]).real.to(torch.float32)
    else:
        llr = llr_compute(d, mag_eff, 2)
    llr = scramble_llrs(llr.reshape(B, -1), (cfg.rnti << 15) + cfg.n_id)
    return uci_decode(cfg.n_bits, cfg.E, llr, list_size=list_size)
