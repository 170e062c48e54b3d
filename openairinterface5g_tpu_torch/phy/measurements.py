"""UE/gNB measurements: RSRP, RSSI, RSRQ, SNR, CQI (TS 38.215).

Port of openairinterface5g_tpu/phy/measurements.py: reductions over
reference-signal REs.
"""
from __future__ import annotations

import numpy as np
import torch

# CQI table 2 (TS 38.214 Table 5.2.2.1-3, 256QAM): SNR thresholds in dB
# (link-level calibrated) -> CQI index, for simple link adaptation
_CQI_SNR_THRESH_DB = np.array(
    [-6.7, -4.7, -2.3, 0.2, 2.4, 4.3, 5.9, 8.1, 10.3, 11.7,
     14.1, 16.3, 18.7, 21.0, 22.7])


def rsrp(h_est: torch.Tensor) -> torch.Tensor:
    """Linear reference-signal received power: mean |h|^2 over the last axis."""
    return torch.mean(h_est.abs() ** 2, dim=-1)


def rssi(grid: torch.Tensor) -> torch.Tensor:
    """Total received power over a grid (..., n_re)."""
    return torch.mean(grid.abs() ** 2, dim=-1)


def rsrq(rsrp_lin: torch.Tensor, rssi_lin: torch.Tensor, n_rb: int) -> torch.Tensor:
    """RSRQ = N * RSRP / RSSI."""
    return n_rb * rsrp_lin / torch.clamp(rssi_lin, min=1e-12)


def snr_db(rsrp_lin: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(rsrp_lin, min=1e-12)
                              / torch.clamp(noise_var, min=1e-12))


def cqi_from_snr(snr: torch.Tensor) -> torch.Tensor:
    """Map SNR (dB) to CQI 1..15 by the threshold table."""
    t = torch.as_tensor(_CQI_SNR_THRESH_DB, dtype=snr.dtype, device=snr.device)
    return torch.sum(snr[..., None] >= t, dim=-1).to(torch.int32)
