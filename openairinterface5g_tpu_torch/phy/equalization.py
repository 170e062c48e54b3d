"""Channel compensation: MRC, closed-form 2-layer MMSE, general MMSE/ZF.

Port of openairinterface5g_tpu/phy/equalization.py.  Outputs are
compensated symbols and per-layer gains (x, mag); the LLR stage scales its
thresholds by mag, so no division reaches it.
"""
from __future__ import annotations

import torch


def mrc_compensate(h: torch.Tensor, y: torch.Tensor):
    """Single-layer matched filter + MRC across rx antennas.

    h, y: (..., n_rx, n_re) -> (x (..., n_re), mag (..., n_re)) with
    x = sum_a conj(h_a) y_a and mag = sum_a |h_a|^2.
    """
    x = torch.sum(torch.conj(h) * y, dim=-2)
    mag = torch.sum(h.abs() ** 2, dim=-2).to(torch.float32)
    return x, mag


def mmse_equalize_2layer(h: torch.Tensor, y: torch.Tensor, nvar):
    """2-layer MMSE per RE: x_hat = (H^H H + nvar I)^-1 H^H y.

    h: (..., n_rx, 2, n_re), y: (..., n_rx, n_re), nvar: scalar or (..., 1).
    Returns (x_hat (..., 2, n_re), eff_mag (..., 2, n_re)); eff_mag is the
    post-MMSE gain diag((G + nvar I)^-1 G), the LLR magnitude.
    """
    hc = torch.conj(h)
    g00 = torch.sum(h[..., 0, :].abs() ** 2, dim=-2)
    g11 = torch.sum(h[..., 1, :].abs() ** 2, dim=-2)
    g01 = torch.sum(hc[..., 0, :] * h[..., 1, :], dim=-2)
    x0 = torch.sum(hc[..., 0, :] * y, dim=-2)
    x1 = torch.sum(hc[..., 1, :] * y, dim=-2)
    a00 = g00 + nvar
    a11 = g11 + nvar
    ag2 = g01.abs() ** 2
    inv_det = 1.0 / (a00 * a11 - ag2)
    e0 = (a11 * x0 - g01 * x1) * inv_det
    e1 = (a00 * x1 - torch.conj(g01) * x0) * inv_det
    m0 = (a11 * g00 - ag2) * inv_det
    m1 = (a00 * g11 - ag2) * inv_det
    return torch.stack([e0, e1], dim=-2), torch.stack([m0, m1], dim=-2).to(torch.float32)


def zf_equalize(h: torch.Tensor, y: torch.Tensor, nvar=0.0):
    """General n_layers <= 4 MMSE/ZF via an explicit solve per RE.

    h: (..., n_rx, L, n_re), y: (..., n_rx, n_re).
    Returns (x (..., L, n_re) compensated, eff (..., L, n_re)).

    The solves are solve_ex without its error check: torch.linalg.solve
    reads the factorisation's status back to the host, which on a CUDA
    tensor waits for the device.  With nvar > 0, A = G + nvar I is
    positive definite and always solvable; a singular A (nvar 0 and a
    rank-deficient h) gives non-finite values instead of an error.
    """
    hm = torch.movedim(h, -1, -3)                # (..., n_re, n_rx, L)
    ym = torch.movedim(y, -1, -2)[..., None]     # (..., n_re, n_rx, 1)
    hh = torch.conj(hm).transpose(-1, -2)
    g = hh @ hm
    L = g.shape[-1]
    a = g + nvar * torch.eye(L, dtype=g.dtype, device=g.device)
    sol = torch.linalg.solve_ex(a, hh @ ym, check_errors=False).result[..., 0]
    effm = torch.diagonal(torch.linalg.solve_ex(a, g, check_errors=False).result,
                          dim1=-2, dim2=-1).real
    return torch.movedim(sol, -1, -2), torch.movedim(effm.to(torch.float32), -1, -2)
