"""CSI-RS transmission and UE measurement / CQI and PMI reporting.

Port of openairinterface5g_tpu/models/csirs.py (gNB TX nr_csi_rs.c, UE
measurement nr_ue_measurements.c).  Row-1 style single-port CSI-RS: one RE
per PRB on the configured symbol, Gold-seeded QPSK; 2 ports (row 3) share
an adjacent RE pair under the frequency OCC.  The UE LS-estimates the
channel there and derives RSRP, noise, SNR, CQI and (2 ports) the PMI.
``csirs_rm_pattern`` gives the REs a PDSCH rate-matches around
(``PuschConfig.rm_res``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..phy import refsig
from ..phy.channel_estimation import ls_estimate
from ..phy.measurements import cqi_from_snr, rsrp, snr_db


@dataclasses.dataclass(frozen=True)
class CsirsConfig:
    n_prb: int = 48
    symbol: int = 6
    re_offset: int = 0       # subcarrier within each PRB
    n_id: int = 0
    slot: int = 0
    density: int = 1         # REs per PRB (per CDM group)
    n_ports: int = 1         # 1 (row 1) or 2 (row 3: CDM2 frequency OCC over an
                             # adjacent RE pair, TS 38.211 Table 7.4.1.5.3-1)


def _sequence(cfg: CsirsConfig, device) -> torch.Tensor:
    cinit = refsig.csirs_cinit(cfg.slot, cfg.symbol, cfg.n_id)
    return torch.as_tensor(refsig.csirs_sequence(cinit, cfg.n_prb), device=device)


def _base(cfg: CsirsConfig) -> np.ndarray:
    return (np.arange(cfg.n_prb) * 12 + cfg.re_offset).astype(np.int64)


def csirs_sc_indices(cfg: CsirsConfig) -> np.ndarray:
    """Occupied subcarriers (both REs of the CDM2 pair for 2 ports)."""
    base = _base(cfg)
    if cfg.n_ports == 1:
        return base.astype(np.int32)
    return np.sort(np.concatenate([base, base + 1])).astype(np.int32)


def csirs_tx_grid(cfg: CsirsConfig, batch: int, n_sc: int,
                  device: torch.device | str) -> torch.Tensor:
    """The CSI-RS symbol's REs (zeros elsewhere) on `device`: (B, n_sc) for 1
    port, (B, 2, n_sc) for 2, port p with the frequency OCC
    w_f = [+1, (+1 | -1)] over the adjacent RE pair."""
    seq = _sequence(cfg, device)
    base = torch.as_tensor(_base(cfg), device=device)
    if cfg.n_ports == 1:
        row = torch.zeros(n_sc, dtype=torch.complex64, device=device)
        row[base] = seq
        return row.expand(batch, n_sc)
    rows = torch.zeros((2, n_sc), dtype=torch.complex64, device=device)
    rows[:, base] = seq
    rows[0, base + 1] = seq
    rows[1, base + 1] = -seq
    return rows.expand(batch, 2, n_sc)


# 2-TX 1-layer PMI codebook, TS 38.214 Table 5.2.2.2.1-1 (W = [1, phi]/sqrt 2)
PMI_CODEBOOK_2TX = np.stack([
    np.array([1.0, 1.0]), np.array([1.0, -1.0]),
    np.array([1.0, 1.0j]), np.array([1.0, -1.0j]),
]).astype(np.complex64) / np.sqrt(2)


def select_pmi(h_ports: torch.Tensor) -> tuple:
    """PMI from per-port channel estimates h_ports (B, n_rx, 2, n_prb) ->
    (pmi (B,) int32, gain (B, 4)): the codebook entry of the largest
    post-precoding power sum_prb sum_rx |sum_p h[r, p] W[i, p]|^2."""
    W = torch.as_tensor(PMI_CODEBOOK_2TX, dtype=h_ports.dtype, device=h_ports.device)
    eff = torch.einsum("brpk,ip->birk", h_ports, W)       # (B, 4, R, n_prb)
    gain = torch.sum(eff.abs() ** 2, dim=(2, 3))           # (B, 4)
    return torch.argmax(gain, dim=-1).to(torch.int32), gain


def csi_measure_2port(cfg: CsirsConfig, rx_symbol: torch.Tensor) -> dict:
    """2-port CSI measurement of the received CSI-RS symbol (B, n_rx, n_sc)
    -> per-port channel, PMI, post-PMI SNR and CQI.  CDM2 separation:
    h_p0 = (y0 + y1) / 2, h_p1 = (y0 - y1) / 2 over the RE pair."""
    if cfg.n_ports != 2:
        raise ValueError("csi_measure_2port needs a 2-port CsirsConfig")
    seq = _sequence(cfg, rx_symbol.device)
    base = torch.as_tensor(_base(cfg), device=rx_symbol.device)
    y0 = rx_symbol[..., base] * torch.conj(seq)
    y1 = rx_symbol[..., base + 1] * torch.conj(seq)
    h = torch.stack([0.5 * (y0 + y1), 0.5 * (y0 - y1)], dim=2)   # (B, R, 2, K)
    pmi, gain = select_pmi(h)
    d = h[..., 1:] - h[..., :-1]
    nvar = torch.mean(d.abs() ** 2, dim=(-1, -2, -3))
    best = torch.max(gain, dim=-1).values / (h.shape[1] * cfg.n_prb)
    snr = snr_db(best, nvar)
    return {"h": h, "pmi": pmi, "gain": gain, "noise_var": nvar,
            "snr_db": snr, "cqi": cqi_from_snr(snr)}


def csi_measure(cfg: CsirsConfig, rx_symbol: torch.Tensor) -> dict:
    """UE measurement of the received CSI-RS symbol (B, n_rx, n_sc) -> rsrp
    (linear), noise_var, snr_db, cqi and the channel h (B, n_rx, n_prb)."""
    seq = _sequence(cfg, rx_symbol.device)
    sc = torch.as_tensor(csirs_sc_indices(cfg), dtype=torch.long, device=rx_symbol.device)
    h = ls_estimate(rx_symbol[..., sc], seq)             # (B, R, n_prb)
    p = rsrp(h).mean(dim=-1)                              # mean over the RX antennas
    d = h[..., 1:] - h[..., :-1]
    nvar = torch.mean(d.abs() ** 2, dim=(-1, -2)) / 2
    snr = snr_db(p, nvar)
    return {"h": h, "rsrp": p, "noise_var": nvar, "snr_db": snr,
            "cqi": cqi_from_snr(snr)}


def csirs_rm_pattern(cfg: CsirsConfig, csirs_prb_start: int, pdsch) -> tuple:
    """((symbol, sc), ...) of the CSI-RS REs inside a PDSCH allocation, sc
    relative to the allocation start: the PDSCH's rm_res, so it rate-matches
    around the CSI-RS (gNB_scheduler_dlsch.c:62 sched_csirs)."""
    sc_abs = csirs_sc_indices(cfg) + 12 * csirs_prb_start
    a0 = pdsch.sc0
    a1 = a0 + 12 * pdsch.n_prb
    return tuple((int(cfg.symbol), int(m - a0)) for m in sc_abs if a0 <= m < a1)
