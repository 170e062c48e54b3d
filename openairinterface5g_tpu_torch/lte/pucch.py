"""LTE PUCCH formats 1/1a/1b (TS 36.211 §5.4.1): SR and 1/2-bit HARQ-ACK on
one PRB pair, and format 2 (§5.4.2): the (20, A) Reed-Muller coded CQI.

Port of openairinterface5g_tpu/lte/pucch.py (the reference's pucch.c).  Per
slot (normal CP): the length-12 base sequence r_{u,v} with a per-symbol
cyclic shift hopped by the cell's Gold sequence; format 1 puts the data on
symbols {0,1,5,6} under a length-4 Walsh cover and the DMRS on {2,3,4} under
a length-3 DFT cover, format 2 the data on {0,2,3,4,6} and the DMRS on
{1,5}; slot 1 hops to the mirrored PRB.  Each slot's shifted sequences are
host constants kept on the device per configuration, so a slot's TX is one
product and its RX a few correlations over the (B, R, 7, 12) tile.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..phy.refsig import low_papr_sequence
from ..phy.scrambling import gold_sequence_np

_W4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1]], np.float32)
_W3 = np.exp(2j * np.pi * np.outer([0, 1, 2], [0, 1, 2]) / 3).astype(np.complex64)
_DATA_SYMS = (0, 1, 5, 6)
_DMRS_SYMS = (2, 3, 4)


@dataclasses.dataclass(frozen=True)
class LtePucch1Config:
    n_rb: int = 25
    cell_id: int = 0
    prb: int = 0                  # slot-0 PRB (slot 1 mirrors)
    n_oc: int = 0                 # orthogonal cover index (0..2)
    cs0: int = 0                  # base cyclic shift alpha index (0..11)
    n_rx: int = 1

    @property
    def mirror_prb(self) -> int:
        return self.n_rb - 1 - self.prb


@functools.lru_cache(maxsize=64)
def _ncs_cell(cell_id: int) -> np.ndarray:
    """(20, 7) per-(slot, symbol) cell cyclic-shift hop (36.211 §5.4:
    n_cs^cell from the cell Gold sequence, 8 bits per symbol)."""
    bits = gold_sequence_np(cell_id, 8 * 7 * 20).reshape(20, 7, 8)
    return (bits * (1 << np.arange(8))).sum(-1) % 12


def _seqs(cell_id: int, cs0: int, ns: int) -> np.ndarray:
    """(7, 12) complex128: r_u with symbol l's cyclic shift in slot ns."""
    r = low_papr_sequence(cell_id % 30, 0, 12)
    ncs = _ncs_cell(cell_id)[ns % 20]
    alpha = 2 * np.pi * ((cs0 + ncs.astype(np.int64)) % 12) / 12
    return r[None, :] * np.exp(1j * alpha[:, None] * np.arange(12)[None, :])


@functools.lru_cache(maxsize=64)
def _f1_consts(cfg: LtePucch1Config, device: torch.device) -> torch.Tensor:
    """(2, 7, 12) complex64 per slot and symbol: the cover-weighted shifted
    sequence (w4 on the data symbols, w3 on the DMRS)."""
    out = np.zeros((2, 7, 12), np.complex64)
    for ns in range(2):
        seq = _seqs(cfg.cell_id, cfg.cs0, ns)
        for i, l in enumerate(_DMRS_SYMS):
            out[ns, l] = seq[l] * _W3[cfg.n_oc][i]
        for i, l in enumerate(_DATA_SYMS):
            out[ns, l] = seq[l] * float(_W4[cfg.n_oc][i])
    return torch.as_tensor(out, device=device)


def _slot_cols(cfg) -> tuple:
    return ((12 * cfg.prb, 12 * cfg.prb + 12), (12 * cfg.mirror_prb, 12 * cfg.mirror_prb + 12))


def pucch1_tx(cfg: LtePucch1Config, bits: torch.Tensor | None,
              device: torch.device | str | None = None) -> torch.Tensor:
    """bits: None (format 1 / SR; on `device`), (B, 1) (1a, BPSK) or (B, 2)
    (1b, QPSK) -> (B, 14, n_sc) subframe RE grid (both slots, mirrored PRB)."""
    if bits is None:
        d = torch.ones((1,), dtype=torch.complex64, device=device)
    else:
        s = 1.0 - 2.0 * bits.to(torch.float32)
        d = torch.complex(s[:, 0], torch.zeros_like(s[:, 0])) if bits.shape[-1] == 1 else \
            torch.complex(s[:, 0], s[:, 1]) / np.sqrt(2)
    dev = d.device
    k = _f1_consts(cfg, dev)
    data = torch.zeros(7, dtype=torch.bool)
    data[list(_DATA_SYMS)] = True
    grid = torch.zeros((d.shape[0], 14, 12 * cfg.n_rb), dtype=torch.complex64, device=dev)
    for ns, (a, b) in enumerate(_slot_cols(cfg)):
        tile = torch.where(data[:, None].to(dev), d[:, None, None] * k[ns], k[ns])
        grid[:, 7 * ns: 7 * ns + 7, a:b] = tile
    return grid


def pucch1_rx(cfg: LtePucch1Config, re_grid: torch.Tensor, n_bits: int = 1) -> dict:
    """(B, R, 14, n_sc) -> dict(d_hat, bits, detected): the channel from the
    DMRS symbols per slot, coherent combining of the data symbols, the DTX
    threshold 0.25 on |d_hat|."""
    k = torch.conj(_f1_consts(cfg, re_grid.device))
    z, e_dmrs = 0.0, 0.0
    for ns, (a, b) in enumerate(_slot_cols(cfg)):
        tile = re_grid[:, :, 7 * ns: 7 * ns + 7, a:b]
        h = 0.0
        for l in _DMRS_SYMS:  # noqa: E741
            h = h + tile[:, :, l, :] * k[ns, l]
        h = h / 3                                                        # (B, R, 12)
        e_dmrs = e_dmrs + torch.mean(h.abs() ** 2, dim=(-2, -1))
        for l in _DATA_SYMS:  # noqa: E741
            z = z + torch.sum(tile[:, :, l, :] * k[ns, l] * torch.conj(h), dim=(-2, -1))
    d_hat = z / (8 * 12 * torch.clamp(e_dmrs, min=1e-12))
    if n_bits == 0:
        bits = None
    elif n_bits == 1:
        bits = (d_hat.real < 0).to(torch.int8)[:, None]
    else:
        bits = torch.stack([d_hat.real < 0, d_hat.imag < 0], dim=-1).to(torch.int8)
    return {"d_hat": d_hat, "bits": bits, "detected": d_hat.abs() > 0.25}


# --------------------------------------------------------------------------
# Format 2 (TS 36.211 §5.4.2): 20 coded UCI bits (CQI/PMI) on one PRB pair
# --------------------------------------------------------------------------

# TS 36.212 Table 5.2.3.3-1: basis sequences M_{i,n} of the (20, A) code
_RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], np.int8)

_F2_DATA_SYMS = (0, 2, 3, 4, 6)     # normal CP; DMRS on l = 1, 5
_F2_DMRS_SYMS = (1, 5)


@functools.lru_cache(maxsize=32)
def _rm20_consts(A: int, device: torch.device):
    """(basis (A, 20) int32, codebook signs (20, 2^A) f32, messages (2^A, A) int8)."""
    idx = np.arange(1 << A)
    a = ((idx[:, None] >> np.arange(A)[None, :]) & 1).astype(np.int8)
    cw = (a @ _RM20_BASIS[:, :A].T) & 1
    return (torch.as_tensor(_RM20_BASIS[:, :A].T.astype(np.int32), device=device),
            torch.as_tensor((1.0 - 2.0 * cw.astype(np.float32)).T.copy(), device=device),
            torch.as_tensor(a, device=device))


def rm20_encode(bits: torch.Tensor) -> torch.Tensor:
    """(B, A <= 13) UCI bits -> (B, 20) codeword (36.212 §5.2.3.3)."""
    M, _, _ = _rm20_consts(bits.shape[-1], bits.device)
    return ((bits.to(torch.int32)[..., None] & M).sum(dim=-2) & 1).to(torch.int8)


def rm20_decode(llrs: torch.Tensor, A: int) -> torch.Tensor:
    """(B, 20) LLRs (> 0 = bit 0) -> (B, A) ML-decoded UCI bits: correlation
    with all 2^A codewords as one matmul, the lowest index on a tie."""
    _, sgn, a = _rm20_consts(A, llrs.device)
    score = llrs.to(torch.float32) @ sgn                                 # (B, 2^A)
    best = score == score.amax(dim=-1, keepdim=True)
    idx = torch.arange(sgn.shape[1], device=llrs.device)
    return a[torch.where(best, idx, sgn.shape[1]).amin(dim=-1)]


@dataclasses.dataclass(frozen=True)
class LtePucch2Config:
    """PUCCH format 2 (36.211 §5.4.2): QPSK-modulated (20, A) RM-coded CQI
    on one PRB pair; data on symbols {0,2,3,4,6} of each slot with
    cyclically shifted base sequences, DMRS on {1,5}."""
    n_rb: int = 25
    cell_id: int = 0
    prb: int = 0
    cs0: int = 0                  # n_PUCCH(2)-derived base shift (0..11)
    rnti: int = 0x1234
    n_bits: int = 4               # A (CQI payload size)
    n_rx: int = 1

    @property
    def mirror_prb(self) -> int:
        return self.n_rb - 1 - self.prb


def _f2_cinit(cfg: LtePucch2Config, ns: int) -> int:
    # 36.211 §5.4.2 scrambling: ((ns/2+1)(2 N_ID+1) << 16) + rnti
    return (((ns // 2 + 1) * (2 * cfg.cell_id + 1) << 16) + cfg.rnti) % (1 << 31)


@functools.lru_cache(maxsize=64)
def _f2_consts(cfg: LtePucch2Config, device: torch.device):
    """((2, 7, 12) complex64 shifted sequences per slot and symbol, (20,) int8
    scrambling bits)."""
    seqs = np.stack([_seqs(cfg.cell_id, cfg.cs0, ns) for ns in range(2)]).astype(np.complex64)
    return (torch.as_tensor(seqs, device=device),
            torch.as_tensor(gold_sequence_np(_f2_cinit(cfg, 0), 20), device=device))


def pucch2_tx(cfg: LtePucch2Config, uci_bits: torch.Tensor) -> torch.Tensor:
    """(B, A) CQI bits -> (B, 14, n_sc) subframe grid (both slots)."""
    seqs, scr = _f2_consts(cfg, uci_bits.device)
    b = rm20_encode(uci_bits) ^ scr                                      # (B, 20)
    s = 1.0 - 2.0 * b.to(torch.float32)
    d = torch.complex(s[:, 0::2], s[:, 1::2]) / np.sqrt(2)               # (B, 10)
    B = d.shape[0]
    grid = torch.zeros((B, 14, 12 * cfg.n_rb), dtype=torch.complex64, device=uci_bits.device)
    for ns, (a, c) in enumerate(_slot_cols(cfg)):
        tile = seqs[ns].expand(B, 7, 12).clone()
        tile[:, list(_F2_DATA_SYMS)] *= d[:, 5 * ns: 5 * ns + 5, None]
        grid[:, 7 * ns: 7 * ns + 7, a:c] = tile
    return grid


def pucch2_rx(cfg: LtePucch2Config, re_grid: torch.Tensor) -> dict:
    """(B, R, 14, n_sc) -> dict(uci (B, A), llrs, detected): the channel per
    slot from the 2 DMRS symbols, coherent demodulation of the 10 data
    symbols, descrambling, (20, A) ML decode.  DTX: with a PUCCH present the
    per-SC DMRS estimates add coherently (|mean_k h|^2 ~ the raw power); on
    noise they average down by 12."""
    seqs, scr = _f2_consts(cfg, re_grid.device)
    k = torch.conj(seqs)
    zs, coh, raw = [], 0.0, 0.0
    for ns, (a, c) in enumerate(_slot_cols(cfg)):
        tile = re_grid[:, :, 7 * ns: 7 * ns + 7, a:c]
        h = 0.0
        for l in _F2_DMRS_SYMS:  # noqa: E741
            h = h + tile[:, :, l, :] * k[ns, l]
        h = h / 2                                                        # (B, R, 12)
        coh = coh + torch.sum(torch.mean(h, dim=-1).abs() ** 2, dim=-1)
        raw = raw + torch.mean(tile.abs() ** 2, dim=(-3, -2, -1))
        for l in _F2_DATA_SYMS:  # noqa: E741
            zs.append(torch.sum(tile[:, :, l, :] * k[ns, l] * torch.conj(h), dim=(-2, -1)))
    z = torch.stack(zs, dim=-1)                                          # (B, 10)
    llr = torch.stack([z.real, z.imag], dim=-1).reshape(z.shape[0], 20)
    llr = llr * (1.0 - 2.0 * scr.to(torch.float32))
    return {"uci": rm20_decode(llr, cfg.n_bits), "llrs": llr,
            "detected": coh > 0.25 * torch.clamp(raw, min=1e-12)}
