"""PDSCH end-to-end chain: gNB TX -> UE RX.

Port of openairinterface5g_tpu/models/pdsch.py (TX nr_generate_pdsch,
nr_dlsch.c:56; RX nr_rx_pdsch, nr_dlsch_demodulation.c:241).  The DL chain
is block for block the UL one (the same codec, scrambler, DMRS type 1 and
QAM; the MIMO receiver runs at the UE), so it runs the tensor chain of
models/pusch.py, with its kernels where the configuration admits them; this
module pins down what is DL's own: the PMI-precoded TX and the 2-codeword
PDSCH of 5 to 8 layers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..phy.modulation import precode
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from .pusch import (PuschConfig, pusch_channel_estimate, pusch_decode_codeword,
                    pusch_equalize, pusch_llrs, pusch_rx, pusch_tx, pusch_tx_grid)


@dataclasses.dataclass(frozen=True)
class PdschConfig(PuschConfig):
    """PDSCH configuration: DMRS type A at symbol 2, the UE receiver MRC/MMSE.

    n_layers = transmission layers (gNB antenna ports, identity precoding),
    n_rx = UE receive antennas.
    """
    mcs_table: int = 1


def pdsch_tx(cfg: PdschConfig, tb_bits: torch.Tensor, rv: int = 0):
    """gNB-side PDSCH TX: (B, TBS) -> ((B, n_ant, samples), (B, G) bits)."""
    return pusch_tx(cfg, tb_bits, rv=rv)


def pdsch_rx(cfg: PdschConfig, rx_samples: torch.Tensor, rv: int = 0,
             n_iters: int = 20, harq_buffers=None) -> dict:
    """UE-side PDSCH RX: channel estimate, MRC/MMSE, LLRs, LDPC decode."""
    return pusch_rx(cfg, rx_samples, rv=rv, n_iters=n_iters, harq_buffers=harq_buffers)


def pdsch_tx_precoded(cfg: PdschConfig, tb_bits: torch.Tensor, W, rv: int = 0):
    """PMI-precoded PDSCH TX: (B, TBS) -> ((B, n_ant, samples), (B, G) bits).

    W: (n_ant, n_layers) codebook precoder (e.g. models.csirs
    PMI_CODEBOOK_2TX[pmi][:, None] for 2 TX, 1 layer).  The DMRS is precoded
    with the data, so the UE estimates the effective channel H W and its
    receiver applies unchanged (nr_layer_precoder:662)."""
    grid_re, scr = pusch_tx_grid(cfg, tb_bits, rv)      # (B, L, S, n_sc)
    W = np.atleast_2d(np.asarray(W)).astype(np.complex64)
    gw = precode(grid_re.transpose(1, 2), W).transpose(1, 2)   # (B, n_ant, S, n_sc)
    fp = cfg.fp
    return ofdm_modulate(fp, map_to_grid(fp, gw), cfg.slot), scr


# --------------------------------------------------------------------------
# Two-codeword PDSCH (5..8 layers, TS 38.211 §7.3.1.2 / 38.212 §7.2.1)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pdsch2CwConfig:
    """2-codeword PDSCH: codeword 0 on the first ceil(L/2) layers, codeword 1
    on the rest (TS 38.211 Table 7.3.1.3-1); scrambling q = 0 / 1; DMRS type
    1 double-symbol (maxLength=2) on ports 0..L-1; one joint channel estimate
    and one joint ZF solve over all L layers at the UE."""
    mu: int = 1
    n_prb: int = 24
    mcs0: int = 9
    mcs1: int = 9
    n_layers: int = 6            # 5..8
    n_rx: int = 8
    dmrs_symbols: tuple = (2, 3)  # consecutive pair(s), maxLength=2
    rnti: int = 0x1234
    n_id: int = 0
    slot: int = 0
    decoder_backend: str = "reference"   # 'reference' | 'kernel'

    @property
    def l0(self) -> int:
        return -(-self.n_layers // 2)

    def cw_cfgs(self) -> tuple[PdschConfig, PdschConfig]:
        if not 5 <= self.n_layers <= 8:
            raise ValueError("2-codeword PDSCH is 5..8 layers")
        common = dict(mu=self.mu, n_prb=self.n_prb, n_rx=self.n_rx,
                      dmrs_symbols=self.dmrs_symbols, dmrs_max_len=2,
                      rnti=self.rnti, n_id=self.n_id, slot=self.slot,
                      decoder_backend=self.decoder_backend)
        cw0 = PdschConfig(mcs=self.mcs0, n_layers=self.l0, dmrs_port0=0,
                          scrambling_q=0, **common)
        cw1 = PdschConfig(mcs=self.mcs1, n_layers=self.n_layers - self.l0,
                          dmrs_port0=self.l0, scrambling_q=1, **common)
        return cw0, cw1


def pdsch2cw_tx(cfg: Pdsch2CwConfig, tb0: torch.Tensor, tb1: torch.Tensor,
                rv: int = 0) -> torch.Tensor:
    """(B, TBS0), (B, TBS1) -> (B, n_layers, samples)."""
    c0, c1 = cfg.cw_cfgs()
    g0, _ = pusch_tx_grid(c0, tb0, rv)        # (B, L0, symbols, n_sc)
    g1, _ = pusch_tx_grid(c1, tb1, rv)
    fp = c0.fp
    return ofdm_modulate(fp, map_to_grid(fp, torch.cat([g0, g1], dim=1)), cfg.slot)


def pdsch2cw_rx(cfg: Pdsch2CwConfig, rx_samples: torch.Tensor, rv: int = 0,
                n_iters: int = 20) -> tuple:
    """(B, n_rx, samples) -> (codeword 0, codeword 1) decode dicts: one joint
    estimate over all L DMRS ports and one joint solve, then per codeword
    its LLRs, descrambling (q = 0 / 1) and LDPC decode."""
    c0, c1 = cfg.cw_cfgs()
    fp = c0.fp
    re_grid = extract_from_grid(fp, ofdm_demodulate(fp, rx_samples, cfg.slot))
    h_est, nvar = pusch_channel_estimate(c0, re_grid, n_ports=cfg.n_layers)
    x, mag = pusch_equalize(c0, re_grid, h_est, nvar)
    outs = []
    for c, sl in ((c0, slice(0, cfg.l0)), (c1, slice(cfg.l0, cfg.n_layers))):
        llr_cw = pusch_llrs(c, re_grid, x[:, sl], mag[:, sl], h_est)
        outs.append(pusch_decode_codeword(c, llr_cw, rv=rv, n_iters=n_iters))
    return tuple(outs)
