"""SRS sounding: UE TX and the gNB's channel and noise estimate.

Port of openairinterface5g_tpu/models/srs.py (srs_rx.c with
nr_srs_channel_estimation, nr_ul_channel_estimation.c:614).  The ports of
one UE differ by a cyclic shift of 8 / n_ports; the receiver nulls the
other ports by averaging each group of n_ports adjacent LS values.
"""
from __future__ import annotations

import dataclasses

import torch

from ..phy import refsig
from ..phy.channel_estimation import ls_estimate
from ..phy.measurements import cqi_from_snr
from .csirs import select_pmi


@dataclasses.dataclass(frozen=True)
class SrsConfig:
    n_prb: int = 48          # sounded bandwidth
    comb: int = 2
    comb_offset: int = 0
    u: int = 0               # sequence group
    cyclic_shift: int = 0
    n_ports: int = 1
    symbol: int = 13


def _port_sequences(cfg: SrsConfig, device) -> torch.Tensor:
    """(n_ports, m_sc) complex64: each port's cyclically shifted sequence."""
    seqs = []
    for p in range(cfg.n_ports):
        cs = (cfg.cyclic_shift + p * (8 // max(cfg.n_ports, 1))) % 8
        seqs.append(torch.as_tensor(refsig.srs_sequence(cfg.n_prb, cfg.comb, cfg.u,
                                                        cyclic_shift=cs)))
    return torch.stack(seqs).to(device)


def _sc(cfg: SrsConfig, device) -> torch.Tensor:
    return torch.as_tensor(refsig.srs_sc_indices(cfg.n_prb, cfg.comb, cfg.comb_offset),
                           dtype=torch.long, device=device)


def srs_tx(cfg: SrsConfig, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
    """(B, n_ports, 12 n_prb) SRS REs on `device` (zeros off the comb)."""
    out = torch.zeros((cfg.n_ports, 12 * cfg.n_prb), dtype=torch.complex64, device=device)
    out[:, _sc(cfg, device)] = _port_sequences(cfg, device)
    return out.expand(batch, cfg.n_ports, 12 * cfg.n_prb)


def srs_rx(cfg: SrsConfig, rx: torch.Tensor) -> dict:
    """(B, n_rx, 12 n_prb) received SRS symbol -> dict(h (B, n_rx, P, m),
    noise_var (B,)): m is the comb's subcarriers for one port, and for P > 1
    the centres of the groups of P (the truncation m - m % P).  The group
    mean divides the noise variance by P, so the residual is scaled back."""
    y = rx[..., _sc(cfg, rx.device)]                       # (B, R, m_sc)
    pil = _port_sequences(cfg, rx.device)
    h = torch.stack([ls_estimate(y, pil[p]) for p in range(cfg.n_ports)], dim=2)
    P = cfg.n_ports
    if P > 1:
        m = h.shape[-1] - (h.shape[-1] % P)
        h = h[..., :m].reshape(*h.shape[:-1], m // P, P).mean(dim=-1)
    d = h[..., 1:] - h[..., :-1]
    nvar = torch.mean(d.abs() ** 2, dim=(-1, -2, -3)) / 2 * P
    return {"h": h, "noise_var": nvar}


def srs_report(cfg: SrsConfig, rx: torch.Tensor, n_subbands: int = 4) -> dict:
    """The sounded channel as UL link-adaptation inputs: h, noise_var,
    wideband_snr_db (B,), subband_snr_db (B, n_subbands), ul_cqi (B,), and for
    2 ports the UL PMI and its codebook gains (models/csirs.py select_pmi)."""
    out = srs_rx(cfg, rx)
    h, nvar = out["h"], out["noise_var"]                   # (B, R, P, m), (B,)
    p_sig = torch.mean(h.abs() ** 2, dim=(1, 2, 3))
    wb_snr = 10.0 * torch.log10(torch.clamp(p_sig, min=1e-12) / torch.clamp(nvar, min=1e-12))
    m = h.shape[-1] - (h.shape[-1] % n_subbands)
    hb = h[..., :m].reshape(*h.shape[:-1], n_subbands, m // n_subbands)
    p_sb = torch.mean(hb.abs() ** 2, dim=(1, 2, 4))
    sb_snr = 10.0 * torch.log10(torch.clamp(p_sb, min=1e-12)
                                / torch.clamp(nvar[:, None], min=1e-12))
    rep = {"h": h, "noise_var": nvar, "wideband_snr_db": wb_snr,
           "subband_snr_db": sb_snr, "ul_cqi": cqi_from_snr(wb_snr)}
    if cfg.n_ports == 2:
        rep["pmi"], rep["pmi_gain"] = select_pmi(h)
    return rep
