"""LTE PUSCH / UL-SCH chain (TS 36.211 §5.3-5.5, TS 36.212 §5.2.2).

Port of openairinterface5g_tpu/lte/pusch.py (ulsch_coding.c,
ulsch_modulation.c, and the eNB's ulsch_demodulation.c / ulsch_decoding.c).
SC-FDMA, one layer: the DFT spread of phy/transform_precoding.py; the DMRS
is the low-PAPR sequence on symbol 3 of each slot (TS 36.211 §5.5.2.1.1),
estimated per slot and averaged; the turbo coding is lte/pdsch.py's, run
through a configuration with the PUSCH's (TBS, G, Qm).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.refsig import low_papr_sequence
from ..phy.scrambling import gold_sequence
from ..phy.transform_precoding import dft_spread, idft_despread
from ..transport import mcs_to_qm_rate
from . import segmentation as seg
from .params import (LteFrameParams, extract_from_grid, make_lte_frame_params, map_to_grid,
                     ofdm_demodulate, ofdm_modulate)
from .pdsch import (LtePdschConfig, dlsch_decode, dlsch_decode_streams, dlsch_deratematch,
                    dlsch_encode, lte_mcs_qm)


@dataclasses.dataclass(frozen=True)
class LtePuschConfig:
    n_rb: int = 25
    n_prb: int = 25
    prb_start: int = 0
    mcs: int = 16
    tbs_override: int | None = None
    cell_id: int = 0
    rnti: int = 0x1234
    subframe: int = 1
    n_rx: int = 1

    @property
    def fp(self) -> LteFrameParams:
        return make_lte_frame_params(self.n_rb)

    @property
    def qm(self) -> int:
        return min(lte_mcs_qm(self.mcs), 6)

    @property
    def dmrs_symbols(self) -> tuple:
        """Symbol 3 of each slot (normal CP)."""
        sps = self.fp.symbols_per_slot
        return (3, sps + 3)

    @property
    def data_symbols(self) -> tuple:
        return tuple(s for s in range(self.fp.symbols_per_subframe)
                     if s not in self.dmrs_symbols)

    @property
    def msc(self) -> int:
        return 12 * self.n_prb

    @property
    def n_data_re(self) -> int:
        return len(self.data_symbols) * self.msc

    @property
    def G(self) -> int:
        return self.n_data_re * self.qm

    @property
    def tbs(self) -> int:
        if self.tbs_override is not None:
            return self.tbs_override
        a = int(self.G * mcs_to_qm_rate(min(self.mcs, 27), 1)[1]) - 24
        return max((a // 8) * 8, 16)

    def seg(self) -> seg.LteSegParams:
        return seg.segment_params(self.tbs + 24)

    def scrambling_cinit(self) -> int:
        """TS 36.211 §5.3.1 (q = 0)."""
        return (self.rnti << 14) + (self.subframe << 9) + self.cell_id

    def dmrs_pilot_np(self, slot_idx: int):
        """The slot's DMRS r_{u,v} (group hopping off; u = cell_id mod 30, the
        reference's default)."""
        return low_papr_sequence(self.cell_id % 30, 0, self.msc)


@dataclasses.dataclass(frozen=True)
class _CodingProxy(LtePdschConfig):
    """An LtePdschConfig with the PUSCH's G: the DL-SCH and UL-SCH share the
    TS 36.212 §5.1 coding."""
    g_override: int = 0

    @property
    def G(self) -> int:  # noqa: N802
        return self.g_override


@functools.lru_cache(maxsize=32)
def _coding_proxy(cfg: LtePuschConfig) -> _CodingProxy:
    return _CodingProxy(n_rb=cfg.n_rb, n_prb=cfg.n_prb, mcs=cfg.mcs, tbs_override=cfg.tbs,
                        g_override=cfg.G)


def ulsch_encode(cfg: LtePuschConfig, tb_bits: torch.Tensor, rv: int = 0) -> torch.Tensor:
    return dlsch_encode(_coding_proxy(cfg), tb_bits, rv)


def ulsch_decode(cfg: LtePuschConfig, llr_cw: torch.Tensor, rv: int = 0,
                 n_iters: int = 6) -> dict:
    return dlsch_decode(_coding_proxy(cfg), llr_cw, rv, n_iters=n_iters)


@functools.lru_cache(maxsize=32)
def _pilots(cfg: LtePuschConfig, device: torch.device) -> tuple:
    return tuple(torch.as_tensor(cfg.dmrs_pilot_np(si), device=device)
                 for si in range(len(cfg.dmrs_symbols)))


def pusch_tx(cfg: LtePuschConfig, tb_bits: torch.Tensor, rv: int = 0):
    """(B, TBS) -> ((B, 1, samples) SC-FDMA subframe, (B, G) scrambled bits)."""
    dev = tb_bits.device
    cw = ulsch_encode(cfg, tb_bits, rv)
    scrambled = cw.to(torch.int8) ^ gold_sequence(cfg.scrambling_cinit(), cfg.G, dev)
    spread = dft_spread(mod.modulate(scrambled, cfg.qm), cfg.msc)     # (B, n_data_re)
    fp, B, a0 = cfg.fp, tb_bits.shape[0], 12 * cfg.prb_start
    grid_re = torch.zeros((B, 1, fp.symbols_per_subframe, fp.n_sc),
                          dtype=torch.complex64, device=dev)
    grid_re[:, 0, list(cfg.data_symbols), a0: a0 + cfg.msc] = spread.reshape(
        B, len(cfg.data_symbols), cfg.msc)
    for s, pil in zip(cfg.dmrs_symbols, _pilots(cfg, dev)):
        grid_re[:, 0, s, a0: a0 + cfg.msc] = pil
    return ofdm_modulate(fp, map_to_grid(fp, grid_re)), scrambled


def pusch_rx(cfg: LtePuschConfig, rx_samples: torch.Tensor, rv: int = 0, n_iters: int = 6,
             acc_streams: list | None = None) -> dict:
    """(B, n_rx, samples) -> decoded TB dict (HARQ combining as pdsch_rx)."""
    fp = cfg.fp
    re_grid = extract_from_grid(fp, ofdm_demodulate(fp, rx_samples))   # (B, R, 14, n_sc)
    a0, M = 12 * cfg.prb_start, cfg.msc
    # per-slot LS at the DMRS, averaged (block fading)
    hs = [re_grid[:, :, s, a0: a0 + M] * torch.conj(pil)
          for s, pil in zip(cfg.dmrs_symbols, _pilots(cfg, rx_samples.device))]
    h = sum(hs) / len(hs)                                              # (B, R, M)
    # MRC per data symbol, then the IDFT despread
    y = re_grid[:, :, list(cfg.data_symbols), a0: a0 + M]
    x = torch.sum(torch.conj(h)[:, :, None, :] * y, dim=1)             # (B, S, M)
    mag = torch.sum(h.abs() ** 2, dim=1)[:, None, :].expand(x.shape)
    B, S, _ = x.shape
    xd, md = idft_despread(x.reshape(B, S * M), mag.reshape(B, S * M), M)
    c = gold_sequence(cfg.scrambling_cinit(), cfg.G, rx_samples.device)
    lls = llr_mod.llrs(xd, md, cfg.qm) * (1.0 - 2.0 * c.to(torch.float32))
    proxy = _coding_proxy(cfg)
    streams = dlsch_deratematch(proxy, lls, rv)
    if acc_streams is not None:
        streams = [a + s for a, s in zip(acc_streams, streams)]
    out = dlsch_decode_streams(proxy, streams, n_iters=n_iters)
    out["llrs"] = lls
    out["streams"] = streams
    return out
