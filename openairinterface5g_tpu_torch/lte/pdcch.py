"""LTE DL control channels: PCFICH, PHICH, PDCCH (TS 36.211 §6.7-6.9,
36.212 §5.3.1/5.3.3).

Port of openairinterface5g_tpu/lte/pdcch.py (the reference's pcfich.c,
phich.c, dci.c and the UE's dci_decoding_procedure).  The REG maps are host
numpy, copied; the DCI codec is the tail-biting Viterbi (coding/viterbi.py)
with conv rate matching (lte/rate_matching.py).  The blind search de-rate-
matches every candidate, stacks them (all have L = A + 16) into one Viterbi
call, and keeps per row the first candidate whose CRC passes in the JAX
package's order (aggregation levels as given, then candidates ascending):
one add-compare-select loop instead of one per candidate.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..coding import viterbi
from ..coding.crc import crc_attach, crc_ok, mask16
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence, gold_sequence_np
from . import rate_matching as rm

# ---------------------------------------------------------------------------
# REG geometry (symbol 0; 2 CRS REs per RB per port pair -> 2 REGs of 4)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def symbol0_regs(n_rb: int, cell_id: int) -> np.ndarray:
    """(n_regs, 4) subcarrier indices of the symbol-0 REGs: in symbol 0 the
    CRS of ports 0/1 take k mod 3 == vshift mod 3, so each RB gives 2 REGs of
    4 REs from its other 8 SCs (36.211 §6.2.4)."""
    vshift3 = (cell_id % 6) % 3
    regs = []
    for rb in range(n_rb):
        scs = [12 * rb + k for k in range(12) if k % 3 != vshift3]
        regs.append(scs[:4])
        regs.append(scs[4:])
    return np.array(regs, np.int64)


def pcfich_reg_indices(n_rb: int, cell_id: int) -> np.ndarray:
    """The 4 PCFICH REG indices (36.211 §6.7.4): quadruplet i starts at
    k = (k_bar + floor(i N_RB / 2) 6) mod n_sc, and each half-RB of 6 SCs
    holds one symbol-0 REG, so the REG index is k // 6."""
    k_bar = 6 * (cell_id % (2 * n_rb))
    return np.array([((k_bar + (i * n_rb // 2) * 6) % (n_rb * 12)) // 6
                     for i in range(4)], np.int64)


def phich_reg_indices(n_rb: int, cell_id: int, n_groups: int = 1) -> np.ndarray:
    """Symbol-0 REG indices of the PHICH groups (36.211 §6.9.3, normal
    duration): n_i' = (N_ID + m' + floor(i n0 / 3)) mod n0 among the n0 REGs
    not assigned to the PCFICH (phich_common.c)."""
    pc = set(pcfich_reg_indices(n_rb, cell_id).tolist())
    non_pcfich = np.array([i for i in range(2 * n_rb) if i not in pc], np.int64)
    n0 = len(non_pcfich)
    return np.array([int(non_pcfich[(cell_id + m + i * n0 // 3) % n0])
                     for m in range(n_groups) for i in range(3)], np.int64)


# CFI codewords (36.212 Table 5.3.4-1)
_CFI_CW = {
    1: [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1],
    2: [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0],
    3: [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
}


def pcfich_cinit(subframe: int, cell_id: int) -> int:
    """36.211 §6.7.1."""
    return ((subframe + 1) * (2 * cell_id + 1) << 9) + cell_id


def _cfi_bits(cfi: int, subframe: int, cell_id: int) -> np.ndarray:
    c = gold_sequence_np(pcfich_cinit(subframe, cell_id), 32).astype(np.int8)
    return np.array(_CFI_CW[cfi], np.int8) ^ c


def pcfich_encode(cfi: int, subframe: int, cell_id: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """CFI -> (16,) QPSK symbols."""
    bits = torch.as_tensor(_cfi_bits(cfi, subframe, cell_id), device=device)
    return mod.modulate(bits[None], 2)[0]


@functools.lru_cache(maxsize=32)
def _cfi_refs(subframe: int, cell_id: int, device: torch.device) -> torch.Tensor:
    """(3, 16) conj of each CFI's scrambled QPSK symbols."""
    const = mod.constellation(2)
    refs = np.stack([const[_cfi_bits(cfi, subframe, cell_id).reshape(16, 2) @ np.array([2, 1])]
                     for cfi in (1, 2, 3)])
    return torch.as_tensor(np.conj(refs), device=device)


def pcfich_decode(y: torch.Tensor, h: torch.Tensor, subframe: int, cell_id: int) -> torch.Tensor:
    """(B, R, 16) received PCFICH REs + channel -> (B,) CFI by ML correlation
    over the 3 codewords (the lowest CFI on a tie)."""
    x = torch.sum(torch.conj(h) * y, dim=1)                              # (B, 16)
    metrics = torch.sum(x[:, None, :] * _cfi_refs(subframe, cell_id, y.device), dim=-1).real
    best = metrics == metrics.amax(dim=-1, keepdim=True)
    idx = torch.arange(3, device=y.device)
    return torch.where(best, idx, 3).amin(dim=-1) + 1


# ---------------------------------------------------------------------------
# PHICH (36.211 §6.9): BPSK ACK, SF4 orthogonal spreading on 3 REGs
# ---------------------------------------------------------------------------

_PHICH_W = np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                     [1, 1, -1, -1], [1, -1, -1, 1]], np.float32)


def phich_encode(ack: int, n_seq: int = 0, device: torch.device | str = "cpu") -> torch.Tensor:
    """1 ACK bit -> (12,) spread BPSK symbols (3 repetitions x SF4)."""
    b = 1.0 - 2.0 * ack
    return torch.as_tensor(np.tile(b * _PHICH_W[n_seq], 3).astype(np.complex64), device=device)


def phich_decode(y: torch.Tensor, h: torch.Tensor, n_seq: int = 0) -> torch.Tensor:
    """(B, R, 12) REs + channel -> (B,) int32 ACK decision (0 = ACK, sent as +1)."""
    x = torch.sum(torch.conj(h) * y, dim=1)                              # (B, 12)
    w = torch.as_tensor(np.tile(_PHICH_W[n_seq], 3), device=y.device)
    corr = torch.sum(x * w, dim=-1).real
    return (corr < 0).to(torch.int32)


# ---------------------------------------------------------------------------
# PDCCH (36.212 §5.3.3 coding, 36.211 §6.8 mapping)
# ---------------------------------------------------------------------------

N_REG_PER_CCE = 9
BITS_PER_CCE = 72


@functools.lru_cache(maxsize=32)
def _pdcch_avail_regs(n_rb: int, cell_id: int, n_phich_groups: int) -> tuple:
    """Symbol-0 REG indices available to the PDCCH (PCFICH and PHICH
    excluded)."""
    used = set(pcfich_reg_indices(n_rb, cell_id).tolist())
    used |= set(phich_reg_indices(n_rb, cell_id, n_phich_groups).tolist())
    return tuple(i for i in range(2 * n_rb) if i not in used)


@functools.lru_cache(maxsize=32)
def _quad_positions(M: int, cell_id: int) -> np.ndarray:
    """(M,) REG slot j of each PDCCH quadruplet m (36.211 §6.8.5): the
    quadruplets are sub-block interleaved (36.212 §5.1.4.2.1, nulls dropped),
    then cyclically shifted by N_ID^cell, so quadruplet m lands at
    j = (perm_inv[m] - N_ID) mod M."""
    v = rm._subblock(M, rm._P_CONV)
    order = v[v >= 0]
    inv = np.empty(M, np.int64)
    inv[order] = np.arange(M)
    return (inv - cell_id) % M


def dci_encode(payload: torch.Tensor, rnti: int, E: int) -> torch.Tensor:
    """(B, A) DCI bits -> (B, E) rate-matched coded bits: the CRC16 masked
    with the RNTI, the tail-biting conv 1/3, conv rate matching."""
    A = payload.shape[1]
    with_crc = crc_attach(payload.to(torch.int8), "16")
    with_crc[:, A:] ^= mask16(rnti, payload.device)
    d = viterbi.streams(viterbi.encode(with_crc))
    return rm.rate_match_tx(d, rm.conv_rm_indices(A + 16, E))


def _decode_masked(d_flat: torch.Tensor, A: int, rnti: int):
    """(N, 3L) stream LLRs -> ((N, A) payload, ok (N,)) under the RNTI mask."""
    bits = viterbi.decode(viterbi.triples(d_flat))
    unmasked = bits.clone()
    unmasked[:, A:] ^= mask16(rnti, bits.device)
    return bits[:, :A], crc_ok(unmasked, "16")


def dci_decode(llr_e: torch.Tensor, A: int, rnti: int):
    """(B, E) coded LLRs -> ((B, A) payload, ok (B,))."""
    L = A + 16
    d_flat = rm.rate_match_rx(llr_e, rm.conv_rm_indices(L, llr_e.shape[1]), 3 * L)
    return _decode_masked(d_flat, A, rnti)


def pdcch_cinit(subframe: int, cell_id: int) -> int:
    """36.211 §6.8.2."""
    return (subframe << 9) + cell_id


def _cce_sc_list(n_rb: int, cell_id: int, cce0: int, aggregation: int,
                 n_phich_groups: int = 1) -> np.ndarray:
    """Subcarrier indices (aggregation * 9 * 4,) of CCEs [cce0, cce0 + agg)
    after the §6.8.5 quadruplet interleave and cell shift over the PDCCH
    REGs."""
    regs = symbol0_regs(n_rb, cell_id)
    avail = _pdcch_avail_regs(n_rb, cell_id, n_phich_groups)
    n_cce = len(avail) // N_REG_PER_CCE
    assert cce0 + aggregation <= n_cce, (
        f"candidate [{cce0}, {cce0 + aggregation}) exceeds the control "
        f"region's {n_cce} CCEs")
    pos = _quad_positions(n_cce * N_REG_PER_CCE, cell_id)
    quads = pos[cce0 * N_REG_PER_CCE: (cce0 + aggregation) * N_REG_PER_CCE]
    return regs[np.asarray(avail)[quads]].reshape(-1)


def pdcch_tx_symbol0(n_rb: int, cell_id: int, subframe: int, payload: torch.Tensor, rnti: int,
                     aggregation: int = 4, cce0: int = 0,
                     n_phich_groups: int = 1) -> torch.Tensor:
    """(B, A) DCI -> (B, n_sc) symbol-0 REs (the PDCCH CCEs from cce0; the
    PCFICH/PHICH REGs left empty for the caller)."""
    dev = payload.device
    E = aggregation * BITS_PER_CCE
    e = dci_encode(payload, rnti, E)
    syms = mod.modulate(e.to(torch.int8) ^ gold_sequence(pdcch_cinit(subframe, cell_id), E, dev), 2)
    sc = torch.as_tensor(_cce_sc_list(n_rb, cell_id, cce0, aggregation, n_phich_groups),
                         device=dev)
    out = torch.zeros((payload.shape[0], 12 * n_rb), dtype=torch.complex64, device=dev)
    out[:, sc] = syms[:, : sc.numel()]
    return out


@functools.lru_cache(maxsize=64)
def _search_space(n_rb: int, cell_id: int, subframe: int, A: int, aggregations: tuple,
                  n_cand: int, cce0_list, device: torch.device):
    """The blind search's candidates in the JAX package's order: (levels
    (C,) int32, per level (sc (n, al*36) long, rate-matching index (al*72,)
    long, descrambling signs (al*72,)), the level's candidate count)."""
    n_cce = len(_pdcch_avail_regs(n_rb, cell_id, 1)) // N_REG_PER_CCE
    L = A + 16
    levels, groups = [], []
    for al in aggregations:
        if al > max(n_cce, 1):
            continue
        E = al * BITS_PER_CCE
        cces = [cand * al for cand in range(min(n_cand, max(n_cce // al, 1)))
                if cce0_list is None or cand * al in cce0_list]
        if not cces:
            continue
        sc = np.stack([_cce_sc_list(n_rb, cell_id, c, al) for c in cces])
        c = gold_sequence_np(pdcch_cinit(subframe, cell_id), E).astype(np.float32)
        groups.append((torch.as_tensor(sc, device=device),
                       torch.as_tensor(rm.conv_rm_indices(L, E), device=device),
                       torch.as_tensor(1.0 - 2.0 * c, device=device), len(cces)))
        levels += [al] * len(cces)
    return torch.tensor(levels, dtype=torch.int32, device=device), groups


def pdcch_blind_decode(y0: torch.Tensor, h: torch.Tensor, n_rb: int, cell_id: int,
                       subframe: int, rnti: int, A: int, aggregations=(1, 2, 4, 8),
                       n_cand: int = 6, cce0_list=None):
    """Symbol-0 REs (B, R, n_sc) + channel (B, R, n_sc) -> the first DCI found.

    Evaluates the UE-specific search space's candidates per aggregation
    level (the dci_decoding_procedure analog); returns (payload (B, A),
    found (B,), level (B,)).  cce0_list restricts the starting CCEs (e.g. to
    separate two same-RNTI DCIs in one subframe)."""
    B, dev = y0.shape[0], y0.device
    cce0s = None if cce0_list is None else tuple(cce0_list)
    levels, groups = _search_space(n_rb, cell_id, subframe, A, tuple(aggregations), n_cand,
                                   cce0s, dev)
    L = A + 16
    if not groups:
        return (torch.zeros((B, A), dtype=torch.int8, device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    x_full = torch.sum(torch.conj(h) * y0, dim=1)                        # (B, n_sc)
    mag_full = torch.sum(h.abs() ** 2, dim=1)
    streams = []
    for sc, idx, sgn, n in groups:
        lls = llr_mod.llrs(x_full[:, sc], mag_full[:, sc], 2) * sgn       # (B, n, E)
        streams.append(rm.rate_match_rx(lls.reshape(B * n, -1), idx, 3 * L).view(B, n, 3 * L))
    d_flat = torch.cat(streams, dim=1)                                   # (B, C, 3L)
    C = d_flat.shape[1]
    payload, ok = _decode_masked(d_flat.reshape(B * C, 3 * L), A, rnti)
    ok = ok.view(B, C)
    first = torch.where(ok, torch.arange(C, device=dev), C).amin(dim=1)  # (B,)
    found = first < C
    pick = first.clamp(max=C - 1)
    pl = payload.view(B, C, A).gather(1, pick[:, None, None].expand(B, 1, A))[:, 0]
    return (torch.where(found[:, None], pl, 0).to(torch.int8), found,
            torch.where(found, levels[pick], 0))
