"""QAM modulation, layer mapping and precoding (TS 38.211 §5.1, §6.3.1.3-5).

Port of openairinterface5g_tpu/phy/modulation.py.  Symbols come from the
38.211 constellation formulas evaluated on bit planes; layer mapping is a
reshape, precoding one matrix product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

QAM_ORDERS = {"pi2bpsk": 1, "bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8}


@functools.lru_cache(maxsize=8)
def constellation(qm: int) -> np.ndarray:
    """(2^qm,) complex64 table indexed by the bit group (b0 = MSB of index)."""
    n = 1 << qm
    idx = np.arange(n)
    b = ((idx[:, None] >> (qm - 1 - np.arange(qm))[None, :]) & 1).astype(np.float64)
    s = 1 - 2 * b
    if qm == 1:  # BPSK: d = (1-2b)/sqrt(2) * (1+j)
        d = s[:, 0] * (1 + 1j) / np.sqrt(2)
    elif qm == 2:
        d = (s[:, 0] + 1j * s[:, 1]) / np.sqrt(2)
    elif qm == 4:
        d = (s[:, 0] * (2 - s[:, 2]) + 1j * s[:, 1] * (2 - s[:, 3])) / np.sqrt(10)
    elif qm == 6:
        d = (s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
             + 1j * s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5]))) / np.sqrt(42)
    elif qm == 8:
        d = (s[:, 0] * (8 - s[:, 2] * (4 - s[:, 4] * (2 - s[:, 6])))
             + 1j * s[:, 1] * (8 - s[:, 3] * (4 - s[:, 5] * (2 - s[:, 7])))) / np.sqrt(170)
    else:
        raise ValueError(f"unsupported Qm={qm}")
    return d.astype(np.complex64)


def modulate(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """(..., E) bits -> (..., E/qm) complex64 symbols (Gray-mapped QAM)."""
    E = bits.shape[-1]
    lead = bits.shape[:-1]
    g = bits.reshape(*lead, E // qm, qm).to(torch.float32)
    s = [1.0 - 2.0 * g[..., k] for k in range(qm)]
    if qm == 1:
        re = s[0] * np.float32(1 / np.sqrt(2))
        im = re
    else:
        k = qm // 2
        norm = np.float32(1 / np.sqrt(2 / 3 * (4 ** k - 1)))

        def nested(planes):
            # s0*(2^{k-1} - s2*(2^{k-2} - ... - s_{2(k-1)}))
            if k == 1:
                return planes[0]
            acc = planes[-1]
            for i in range(k - 2, 0, -1):
                acc = planes[i] * (float(1 << (k - 1 - i)) - acc)
            return planes[0] * (float(1 << (k - 1)) - acc)

        re = nested(s[0::2]) * norm
        im = nested(s[1::2]) * norm
    return torch.complex(re, im)


def layer_map(symbols: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Single-codeword layer mapping: (..., M) -> (..., L, M/L); symbol i
    goes to layer i % L."""
    M = symbols.shape[-1]
    lead = symbols.shape[:-1]
    return symbols.reshape(*lead, M // n_layers, n_layers).transpose(-1, -2)


def layer_demap(layers: torch.Tensor) -> torch.Tensor:
    """Inverse of layer_map: (..., L, M/L) -> (..., M)."""
    L, ml = layers.shape[-2:]
    return layers.transpose(-1, -2).reshape(*layers.shape[:-2], L * ml)


def precode(layers: torch.Tensor, W) -> torch.Tensor:
    """Apply the precoder W (n_ant, n_layers) to (..., n_layers, M) layer
    symbols -> (..., n_ant, M)."""
    W = torch.as_tensor(W, device=layers.device).to(layers.dtype)
    return torch.einsum("al,...lm->...am", W, layers)
