"""LTE PDSCH / DL-SCH chain (TS 36.211 §6.3-6.4, TS 36.212 §5.3.2).

Port of openairinterface5g_tpu/lte/pdsch.py (dlsch_coding.c,
dlsch_modulation.c, and the UE's dlsch_demodulation.c / dlsch_decoding.c).
Antenna port 0 with MRC over the RX antennas; the control region (the first
n_ctrl_syms symbols) and the CRS REs carry no data.  The segmentation and
rate-matching indices, the RE map, the CRS pilots and the interpolation
matrix are host constants, kept on the device per configuration; each size
group's code blocks go through one batched turbo decode.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..coding import turbo
from ..coding.crc import CRC_POLYS, crc_attach, crc_ok
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence
from ..transport import mcs_to_qm_rate
from . import rate_matching as rm
from . import refsig
from . import segmentation as seg
from .params import (LteFrameParams, extract_from_grid, make_lte_frame_params, map_to_grid,
                     ofdm_demodulate, ofdm_modulate)


def lte_mcs_qm(mcs: int) -> int:
    """TS 36.213 Table 7.1.7.1-1's modulation order of I_MCS."""
    return 2 if mcs <= 9 else 4 if mcs <= 16 else 6


# TBS per subframe at the standard peak points (TS 36.213 Table 7.1.7.2.1-1 at
# I_TBS 26): the LTE FDD DL throughputs at 5/10/20 MHz MCS 28 in BASELINE.md
PEAK_TBS = {25: 18336, 50: 36696, 100: 75376}


@dataclasses.dataclass(frozen=True)
class LtePdschConfig:
    n_rb: int = 50                  # carrier bandwidth
    n_prb: int = 50                 # allocation size (contiguous from prb_start)
    prb_start: int = 0
    mcs: int = 28
    tbs_override: int | None = None
    n_ctrl_syms: int = 1            # PDCCH control region (CFI)
    cell_id: int = 0
    rnti: int = 0x1234
    subframe: int = 1               # clear of PSS/SSS/PBCH (subframes 0/5)
    n_rx: int = 1
    n_crs_ports: int = 1            # CRS ports whose REs are reserved

    @property
    def fp(self) -> LteFrameParams:
        return make_lte_frame_params(self.n_rb)

    @property
    def qm(self) -> int:
        return lte_mcs_qm(self.mcs)

    @property
    def target_rate(self) -> float:
        """Approximate code rate for the TBS where no override or peak value
        applies (the exact TS 36.213 TBS table is data, not behaviour)."""
        return mcs_to_qm_rate(min(self.mcs, 27), 1)[1]

    def _crs_syms(self) -> tuple:
        """Subframe symbols carrying CRS (normal CP, ports 0/1)."""
        sps = self.fp.symbols_per_slot
        return (0, sps - 3, sps, 2 * sps - 3)

    @functools.cached_property
    def data_re_map(self) -> tuple:
        """(sym_ids, sc_ids) of the PDSCH REs in mapping order (TS 36.211
        §6.3.5: k fastest, then l), without the control region and CRS REs."""
        a0 = 12 * self.prb_start
        reserved = {}
        for s in self._crs_syms():
            _, l = divmod(s, self.fp.symbols_per_slot)  # noqa: E741
            ports = range(max(self.n_crs_ports, 2) if self.n_crs_ports > 1 else 1)
            reserved[s] = set(np.concatenate(
                [refsig.crs_sc_indices(self.n_rb, p, l, self.cell_id) for p in ports]).tolist())
        sym_ids, sc_ids = [], []
        for s in range(self.n_ctrl_syms, self.fp.symbols_per_subframe):
            res = reserved.get(s, ())
            for k in range(a0, a0 + 12 * self.n_prb):
                if k not in res:
                    sym_ids.append(s)
                    sc_ids.append(k)
        return np.array(sym_ids, np.int64), np.array(sc_ids, np.int64)

    @property
    def n_data_re(self) -> int:
        return len(self.data_re_map[0])

    @property
    def G(self) -> int:
        return self.n_data_re * self.qm

    @property
    def tbs(self) -> int:
        if self.tbs_override is not None:
            return self.tbs_override
        if self.mcs == 28 and self.n_prb in PEAK_TBS and self.n_prb == self.n_rb:
            return PEAK_TBS[self.n_prb]
        a = int(self.G * self.target_rate) - 24
        return max((a // 8) * 8, 16)

    def seg(self) -> seg.LteSegParams:
        return seg.segment_params(self.tbs + 24)

    def scrambling_cinit(self, q: int = 0) -> int:
        """TS 36.211 §6.3.1: c_init = n_RNTI 2^14 + q 2^13 + ns/2 2^9 + N_ID."""
        return (self.rnti << 14) + (q << 13) + (self.subframe << 9) + self.cell_id


# ---------------------------------------------------------------------------
# DL-SCH coding (TS 36.212 §5.3.2): CRC -> segment -> turbo -> RM -> concat
# ---------------------------------------------------------------------------

def _blocks(cfg: LtePdschConfig):
    """Per code block in transmission order: (K, E, F of the block)."""
    p = cfg.seg()
    es = rm.cb_e_sizes(cfg.G, p.C, cfg.qm)
    out = []
    for K, cnt, _ in seg._groups(p):
        for _ in range(cnt):
            r = len(out)
            out.append((K, es[r], p.F if r == 0 else 0))
    return out


def dlsch_encode(cfg: LtePdschConfig, tb_bits: torch.Tensor, rv: int = 0) -> torch.Tensor:
    """(B, TBS) -> (B, G) rate-matched codeword bits."""
    p = cfg.seg()
    dev = tb_bits.device
    groups = seg.segment_tb(crc_attach(tb_bits.to(torch.int8), "24A"), p)
    blocks = iter(_blocks(cfg))
    out = []
    for cbs in groups:                                  # (B, cnt, K)
        B, cnt, K = cbs.shape
        d = torch.cat(turbo.encode(cbs.reshape(B * cnt, K)), dim=-1).reshape(B, cnt, -1)
        for i in range(cnt):
            _, E, F = next(blocks)
            out.append(rm.rate_match_tx(d[:, i], rm.turbo_rm_index_tensor(K, E, rv, F, dev)))
    return torch.cat(out, dim=-1)


def dlsch_deratematch(cfg: LtePdschConfig, llr_cw: torch.Tensor, rv: int = 0) -> list:
    """(B, G) codeword LLRs -> per size group (B, cnt, 3D) stream LLRs, a list,
    so that HARQ rounds of different rv combine by adding the lists."""
    p = cfg.seg()
    blocks = _blocks(cfg)
    offs = np.concatenate([[0], np.cumsum([E for _, E, _ in blocks])])
    streams, r = [], 0
    for K, cnt, _ in seg._groups(p):
        D = K + 4
        lls = []
        for _ in range(cnt):
            _, E, F = blocks[r]
            idx = rm.turbo_rm_index_tensor(K, E, rv, F, llr_cw.device)
            lls.append(rm.rate_match_rx(llr_cw[:, offs[r]: offs[r + 1]], idx, 3 * D, F=F, D=D))
            r += 1
        streams.append(torch.stack(lls, dim=1))
    return streams


def dlsch_decode_streams(cfg: LtePdschConfig, streams: list, n_iters: int = 6) -> dict:
    """Per-group stream LLRs (dlsch_deratematch's, HARQ-combined or not) ->
    dict(tb_bits, tb_ok, cb_ok)."""
    p = cfg.seg()
    groups_out, cb_oks = [], []
    for (K, cnt, _), ld in zip(seg._groups(p), streams):
        D = K + 4
        B = ld.shape[0]
        ld = ld.reshape(B * cnt, 3 * D)
        bits, _ = turbo.decode(ld[:, :D], ld[:, D: 2 * D], ld[:, 2 * D:], n_iters=n_iters)
        bits = bits.reshape(B, cnt, K)
        if p.cb_crc:
            cb_oks.append(crc_ok(bits, "24B"))
        groups_out.append(bits)
    tb_with_crc = seg.desegment_tb(groups_out, p)
    tb_ok = crc_ok(tb_with_crc, "24A")
    cb_ok = torch.cat(cb_oks, dim=1) if cb_oks else tb_ok[:, None]
    return {"tb_bits": tb_with_crc[..., :-CRC_POLYS["24A"][0]], "tb_ok": tb_ok, "cb_ok": cb_ok}


def dlsch_decode(cfg: LtePdschConfig, llr_cw: torch.Tensor, rv: int = 0,
                 n_iters: int = 6) -> dict:
    """(B, G) codeword LLRs -> dict(tb_bits, tb_ok, cb_ok)."""
    return dlsch_decode_streams(cfg, dlsch_deratematch(cfg, llr_cw, rv), n_iters=n_iters)


# ---------------------------------------------------------------------------
# TX / RX subframe chains
# ---------------------------------------------------------------------------

class _Consts(NamedTuple):
    sym: torch.Tensor           # (N,) long: data REs' symbols
    sc: torch.Tensor            # (N,) long: their subcarriers
    crs: tuple                  # per CRS symbol: (symbol, sc (2 n_rb,), pilots)
    interp: torch.Tensor        # (n_sc, n_pil) complex64 interpolation weights
    order: torch.Tensor         # (n_pil,) long: the merged combs in sc order
    combs: tuple                # per comb offset, sorted: the CRS symbols' indices


@functools.lru_cache(maxsize=32)
def _consts(cfg: LtePdschConfig, device: torch.device) -> _Consts:
    fp = cfg.fp
    crs, by_comb = [], {}
    for i, s in enumerate(cfg._crs_syms()):
        sl, l = divmod(s, fp.symbols_per_slot)  # noqa: E741
        sc = refsig.crs_sc_indices(cfg.n_rb, 0, l, cfg.cell_id)
        pil = refsig.crs_sequence_np(2 * cfg.subframe + sl, l, cfg.cell_id, cfg.n_rb)
        crs.append((s, torch.as_tensor(sc, device=device), torch.as_tensor(pil, device=device)))
        by_comb.setdefault(int(sc[0]), []).append(i)
    offs = sorted(by_comb)
    pil_sc = np.concatenate([o + 6 * np.arange(2 * cfg.n_rb) for o in offs])
    order = np.argsort(pil_sc, kind="stable")
    W = _interp_matrix(fp.n_sc, tuple(pil_sc[order].tolist()))
    sym_ids, sc_ids = cfg.data_re_map
    return _Consts(torch.as_tensor(sym_ids, device=device), torch.as_tensor(sc_ids, device=device),
                   tuple(crs), torch.as_tensor(W, device=device).to(torch.complex64),
                   torch.as_tensor(order, device=device), tuple(tuple(by_comb[o]) for o in offs))


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_sc: int, pil_sc: tuple) -> np.ndarray:
    """(n_sc, n_pil) linear interpolation / edge-hold weights."""
    pil = np.asarray(pil_sc, np.int64)
    W = np.zeros((n_sc, len(pil)), np.float32)
    for k in range(n_sc):
        j = np.searchsorted(pil, k)
        if j == 0:
            W[k, 0] = 1.0
        elif j >= len(pil):
            W[k, -1] = 1.0
        else:
            t = (k - pil[j - 1]) / (pil[j] - pil[j - 1])
            W[k, j - 1] = 1.0 - t
            W[k, j] = t
    return W


def pdsch_tx(cfg: LtePdschConfig, tb_bits: torch.Tensor, rv: int = 0, pdcch_row=None):
    """(B, TBS) -> ((B, 1, samples) subframe, (B, G) scrambled bits).

    pdcch_row: optional (B, n_sc) control-region REs added onto symbol 0, so
    one subframe carries the PDCCH and the PDSCH."""
    dev = tb_bits.device
    cw = dlsch_encode(cfg, tb_bits, rv)
    scrambled = cw.to(torch.int8) ^ gold_sequence(cfg.scrambling_cinit(), cfg.G, dev)
    fp, k = cfg.fp, _consts(cfg, dev)
    grid_re = torch.zeros((tb_bits.shape[0], 1, fp.symbols_per_subframe, fp.n_sc),
                          dtype=torch.complex64, device=dev)
    grid_re[:, 0, k.sym, k.sc] = mod.modulate(scrambled, cfg.qm)
    for s, sc, pil in k.crs:                           # CRS port 0, the full carrier
        grid_re[:, 0, s, sc] = pil
    if pdcch_row is not None:
        grid_re[:, 0, 0, :] += pdcch_row
    return ofdm_modulate(fp, map_to_grid(fp, grid_re)), scrambled


def crs_channel_estimate(cfg: LtePdschConfig, re_grid: torch.Tensor):
    """CRS LS and frequency interpolation -> ((B, R, n_sc) h, (B,) nvar).

    LS at the port-0 CRS REs of the 4 CRS symbols, averaged per comb offset
    (block fading); the merged 3-spaced comb interpolated to every
    subcarrier by one matrix (lte_dl_channel_estimation.c's filters); the
    noise from adjacent pilot differences on the first comb."""
    k = _consts(cfg, re_grid.device)
    ls = [re_grid[:, :, s, sc] * torch.conj(pil) for s, sc, pil in k.crs]
    ls_avg = [sum(ls[i] for i in idx) / len(idx) for idx in k.combs]
    h_pil = torch.cat(ls_avg, dim=-1)[..., k.order]
    h = torch.einsum("brp,sp->brs", h_pil, k.interp)
    d = ls_avg[0][..., 1:] - ls_avg[0][..., :-1]
    return h, torch.mean(d.abs() ** 2, dim=(-2, -1))


def pdsch_rx(cfg: LtePdschConfig, rx_samples: torch.Tensor, rv: int = 0, n_iters: int = 6,
             acc_streams: list | None = None) -> dict:
    """(B, n_rx, samples) subframe -> dict(tb_bits, tb_ok, cb_ok, llrs,
    streams).  acc_streams: the earlier rounds' stream LLRs, to which this
    round's are added (HARQ chase / IR combining)."""
    fp = cfg.fp
    re_grid = extract_from_grid(fp, ofdm_demodulate(fp, rx_samples))   # (B, R, 14, n_sc)
    h, _ = crs_channel_estimate(cfg, re_grid)
    # MRC over the RX antennas, then the data REs in mapping order
    x_full = torch.sum(torch.conj(h)[:, :, None, :] * re_grid, dim=1)
    mag_full = torch.sum(h.abs() ** 2, dim=1)[:, None, :].expand(-1, fp.symbols_per_subframe, -1)
    k = _consts(cfg, rx_samples.device)
    x, mag = x_full[:, k.sym, k.sc], mag_full[:, k.sym, k.sc]
    c = gold_sequence(cfg.scrambling_cinit(), cfg.G, rx_samples.device)
    lls = llr_mod.llrs(x, mag, cfg.qm) * (1.0 - 2.0 * c.to(torch.float32))
    streams = dlsch_deratematch(cfg, lls, rv)
    if acc_streams is not None:
        streams = [a + s for a, s in zip(acc_streams, streams)]
    out = dlsch_decode_streams(cfg, streams, n_iters=n_iters)
    out["llrs"] = lls
    out["streams"] = streams
    return out
