"""PRACH preamble generation + detection.

Port of openairinterface5g_tpu/models/prach.py.  Zadoff-Chu preambles
x_u(n) = exp(-j pi u n(n+1)/L) with cyclic shifts C_v; detection is a
frequency-domain correlation against each root (one multiply and a
zero-padded IFFT, batched over occasions and antennas) followed by a peak
search per shift window.  The time-domain occasion (``PrachTdConfig``)
adds the CP, the repetitions and the PRACH FFT around it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..data.prach_tables import PRACH_ROOT_MAP_0_3, PRACH_ROOT_MAP_4

# N_CS tables, TS 38.211 Table 6.3.3.1-5 (1.25 kHz), -6 (5 kHz),
# -7 (short 15*2^mu kHz); index = zeroCorrelationZoneConfig.  Columns:
# unrestricted / restricted type A / restricted type B.
NCS_125_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93,
                        119, 167, 279, 419)
NCS_125_RESTRICTED_A = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128,
                        158, 202, 237)
NCS_125_RESTRICTED_B = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 118,
                        137)
NCS_5_UNRESTRICTED = (0, 13, 26, 33, 38, 41, 49, 55, 64, 76, 93, 119, 139,
                      209, 279, 419)
NCS_5_RESTRICTED_A = (36, 57, 72, 81, 89, 94, 103, 112, 121, 132, 137, 152,
                      173, 195, 216, 237)
NCS_5_RESTRICTED_B = (36, 57, 60, 63, 65, 68, 71, 77, 81, 85, 97, 109, 122,
                      137)
NCS_SHORT = (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69)


def get_ncs(index: int, fmt: str, restricted: int = 0) -> int:
    """zeroCorrelationZoneConfig -> N_CS: restricted sets exist only for the
    long 1.25/5 kHz formats."""
    if fmt in ("0", "1", "2"):
        return (NCS_125_UNRESTRICTED, NCS_125_RESTRICTED_A,
                NCS_125_RESTRICTED_B)[restricted][index]
    if fmt == "3":
        return (NCS_5_UNRESTRICTED, NCS_5_RESTRICTED_A,
                NCS_5_RESTRICTED_B)[restricted][index]
    return NCS_SHORT[index]


def nr_roots(logical_start: int, count: int, l_ra: int = 839) -> tuple:
    """Physical roots for logical indices i..i+count-1 (TS 38.211 Table
    6.3.3.1-3/-4)."""
    table = PRACH_ROOT_MAP_0_3 if l_ra == 839 else PRACH_ROOT_MAP_4
    return tuple(table[(logical_start + i) % len(table)] for i in range(count))


def _du(u: int, l_ra: int) -> int:
    """Doppler shift distance d_u (38.211 §6.3.3.1): the cyclic shift a
    one-subcarrier Doppler error induces on root u."""
    p = pow(u, -1, l_ra)
    return p if 2 * p < l_ra else l_ra - p


def cyclic_shifts(u: int, l_ra: int, n_cs: int, restricted: int = 0) -> tuple:
    """Allowed cyclic shifts C_v for root u (TS 38.211 §6.3.3.1).

    Unrestricted: C_v = v*N_CS.  Restricted type A/B: shifts arranged in
    groups so the Doppler aliases at +-d_u never fall into another
    preamble's zone.  Returns () when the root supports no shifts."""
    if restricted == 0:
        if n_cs == 0:
            return (0,)
        return tuple(range(0, (l_ra // n_cs) * n_cs, n_cs))
    du = _du(u, l_ra)
    if restricted == 1:                       # type A
        if n_cs <= du < (l_ra + 2) // 3:
            n_shift = du // n_cs
            d_start = 2 * du + n_shift * n_cs
            n_group = l_ra // d_start
            n_bar = min(max((l_ra - 2 * du - n_group * d_start) // n_cs, 0), n_shift)
        elif (l_ra + 2) // 3 <= du <= (l_ra - n_cs) // 2:
            n_shift = (l_ra - 2 * du) // n_cs
            d_start = l_ra - 2 * du + n_shift * n_cs
            n_group = du // d_start
            n_bar = min(max((du - n_group * d_start) // n_cs, 0), n_shift)
        else:
            return ()
    else:                                     # type B (primary ranges)
        if n_cs <= du < l_ra // 5:
            n_shift = du // n_cs
            d_start = 4 * du + n_shift * n_cs
            n_group = l_ra // d_start
            n_bar = min(max((l_ra - 4 * du - n_group * d_start) // n_cs, 0), n_shift)
        elif l_ra // 5 <= du <= (l_ra - n_cs) // 4:
            n_shift = (l_ra - 4 * du) // n_cs
            d_start = l_ra - 4 * du + n_shift * n_cs
            n_group = du // d_start
            n_bar = min(max((du - n_group * d_start) // n_cs, 0), n_shift)
        else:
            return ()                         # remaining B ranges: no shifts
    w = n_shift * n_group + n_bar
    return tuple(d_start * (v // n_shift) + (v % n_shift) * n_cs for v in range(w))


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    l_ra: int = 839             # 839 (formats 0-3) or 139 (A/B formats)
    roots: tuple = (129,)       # physical root sequence indices u
    n_cs: int = 13              # cyclic shift step (zeroCorrelationZone)
    n_ifft: int = 1024          # correlation IFFT size (>= l_ra)
    threshold: float = 10.0     # peak/mean detection threshold
    restricted: int = 0         # 0 | 1 (type A) | 2 (type B) high-speed set

    @property
    def shifts_per_root(self) -> int:
        return self.l_ra // self.n_cs if self.n_cs else 1

    @functools.cached_property
    def preamble_map(self) -> tuple:
        """(root u, C_v) per preamble index, roots consumed in order
        (38.211 §6.3.3.1: preambles from successive logical roots)."""
        return tuple((u, cv) for u in self.roots
                     for cv in cyclic_shifts(u, self.l_ra, self.n_cs, self.restricted))

    @property
    def n_preambles(self) -> int:
        return len(self.preamble_map)


@functools.lru_cache(maxsize=32)
def zc_sequence(u: int, l_ra: int) -> np.ndarray:
    n = np.arange(l_ra, dtype=np.float64)
    return np.exp(-1j * np.pi * u * n * (n + 1) / l_ra).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def zc_freq(u: int, l_ra: int) -> np.ndarray:
    """DFT of the ZC root (host constant)."""
    return np.fft.fft(zc_sequence(u, l_ra)).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _preamble_table(cfg: PrachConfig, device: torch.device) -> torch.Tensor:
    """(n_preambles, L) frequency-domain preambles: each root's DFT times the
    phase ramp of its cyclic shift."""
    rows = []
    for u, cv in cfg.preamble_map:
        ramp = np.exp(2j * np.pi * cv * np.arange(cfg.l_ra) / cfg.l_ra)
        rows.append(zc_freq(u, cfg.l_ra) * ramp.astype(np.complex64))
    return torch.as_tensor(np.stack(rows), device=device)


def prach_tx(cfg: PrachConfig, preamble_idx: torch.Tensor) -> torch.Tensor:
    """(B,) preamble indices -> (B, l_ra) frequency-domain preamble;
    preamble i is (root, C_v) = cfg.preamble_map[i]."""
    return _preamble_table(cfg, preamble_idx.device)[preamble_idx.long()]


@functools.lru_cache(maxsize=32)
def _rx_consts(cfg: PrachConfig, device: torch.device):
    """(the conjugated DFTs of the searched roots (n_roots, L), per preamble
    its root's row, and its shift window's IFFT bins (n_preambles, win))."""
    # the order of the JAX model's Python set of roots, which its noise
    # floor sums in
    roots = list({u for u, _ in cfg.preamble_map})
    row = {u: i for i, u in enumerate(roots)}
    win = max(cfg.n_ifft * cfg.n_cs // cfg.l_ra, 1)
    pre_row, idx = [], []
    for u, cv in cfg.preamble_map:
        # window for shift C_v: time offsets [-Cv .. -Cv + win) mod n_ifft
        start = (cfg.n_ifft - (cv * cfg.n_ifft) // cfg.l_ra) % cfg.n_ifft
        pre_row.append(row[u])
        idx.append((start + np.arange(win)) % cfg.n_ifft)
    xf = np.stack([np.conj(zc_freq(u, cfg.l_ra)) for u in roots])
    return (torch.as_tensor(xf, device=device),
            torch.as_tensor(np.array(pre_row), dtype=torch.long, device=device),
            torch.as_tensor(np.stack(idx), dtype=torch.long, device=device))


def prach_rx(cfg: PrachConfig, rx_freq: torch.Tensor) -> dict:
    """(B, n_rx, l_ra) received frequency-domain PRACH -> detection results.

    Returns dict: detected (B,) bool, preamble (B,) long, delay (B,) long
    (samples at the n_ifft rate), metric (B,).  The noise floor is the mean
    correlation power over all lags of all searched roots.
    """
    xf, pre_row, idx = _rx_consts(cfg, rx_freq.device)
    prod = rx_freq[:, None] * xf[None, :, None]                   # (B, U, R, L)
    corr = torch.fft.ifft(prod, n=cfg.n_ifft, dim=-1)
    power = torch.sum(corr.abs() ** 2, dim=2)                    # (B, U, n_ifft)
    w = power[:, pre_row[:, None], idx]                          # (B, n_pre, win)
    peak_pow, peak_pos = w.amax(dim=-1), torch.argmax(w, dim=-1)   # ties: the first
    means = power.mean(dim=-1)                                   # (B, U)
    mean_pow = means[:, 0]
    for i in range(1, means.shape[1]):                           # roots in order
        mean_pow = mean_pow + means[:, i]
    mean_pow = mean_pow / means.shape[1]
    best = torch.argmax(peak_pow, dim=-1)
    best_pow = torch.gather(peak_pow, 1, best[:, None])[:, 0]
    metric = best_pow / torch.clamp(mean_pow, min=1e-12)
    delay = torch.gather(peak_pos, 1, best[:, None])[:, 0]
    return {"detected": metric > cfg.threshold, "preamble": best, "delay": delay,
            "metric": metric}


# --------------------------------------------------------------------------
# Time-domain PRACH (TS 38.211 Table 6.3.3.1-1/-2): long formats 0-3 and
# short formats A1..B4 in the sample stream
# --------------------------------------------------------------------------

# format -> (l_ra, scs in Hz (long) or None (short: 15 kHz * 2^mu), n_rep,
# the CP in kappa*Ts units (long) / kappa*2^-mu*Ts units (short))
PRACH_FORMATS = {
    "0":  (839, 1250, 1, 3168),
    "1":  (839, 1250, 2, 21024),
    "2":  (839, 1250, 4, 4688),
    "3":  (839, 5000, 4, 3168),
    "A1": (139, None, 2, 288),
    "A2": (139, None, 4, 576),
    "A3": (139, None, 6, 864),
    "B1": (139, None, 2, 216),
    "B2": (139, None, 4, 360),
    "B3": (139, None, 6, 504),
    "B4": (139, None, 12, 936),
}


@dataclasses.dataclass(frozen=True)
class PrachTdConfig:
    """Time-domain PRACH occasion at a given sample rate."""

    fmt: str = "0"
    mu: int = 1                  # slot numerology (for short formats / fs)
    sample_rate: float = 61.44e6
    k0: int = 12                 # first PRACH subcarrier bin in the PRACH FFT
    roots: tuple = (129,)
    n_cs: int = 13
    threshold: float = 10.0
    restricted: int = 0          # high-speed restricted set (long formats)

    @property
    def l_ra(self) -> int:
        return PRACH_FORMATS[self.fmt][0]

    @property
    def scs(self) -> float:
        s = PRACH_FORMATS[self.fmt][1]
        return float(s) if s else 15e3 * 2 ** self.mu

    @property
    def n_rep(self) -> int:
        return PRACH_FORMATS[self.fmt][2]

    @property
    def n_fft(self) -> int:
        n = self.sample_rate / self.scs
        if abs(n - round(n)) >= 1e-9:
            raise ValueError("sample rate not a multiple of the PRACH SCS")
        return int(round(n))

    @property
    def cp_samples(self) -> int:
        cp_k = PRACH_FORMATS[self.fmt][3]
        scale = self.sample_rate / 30.72e6
        if PRACH_FORMATS[self.fmt][1] is None:  # short: kappa*2^-mu units
            scale /= 2 ** self.mu
        return int(round(cp_k * scale))

    @property
    def n_samples(self) -> int:
        return self.cp_samples + self.n_rep * self.n_fft

    def freq_cfg(self) -> PrachConfig:
        return PrachConfig(l_ra=self.l_ra, roots=self.roots, n_cs=self.n_cs,
                           n_ifft=1024 if self.l_ra == 839 else 256,
                           threshold=self.threshold, restricted=self.restricted)


def prach_td_tx(cfg: PrachTdConfig, preamble_idx: torch.Tensor) -> torch.Tensor:
    """(B,) preamble indices -> (B, n_samples) time-domain PRACH burst: L_RA
    subcarriers at bins k0..k0+L_RA-1 of the PRACH-sized IFFT, repeated
    n_rep times behind one CP."""
    xf = prach_tx(cfg.freq_cfg(), preamble_idx)             # (B, L)
    B = xf.shape[0]
    spec = torch.zeros((B, cfg.n_fft), dtype=torch.complex64, device=xf.device)
    spec[:, cfg.k0: cfg.k0 + cfg.l_ra] = xf
    sym = torch.fft.ifft(spec, dim=-1) * np.sqrt(cfg.n_fft)
    body = sym.repeat(1, cfg.n_rep)
    cp = body[:, body.shape[-1] - cfg.cp_samples:]
    return torch.cat([cp, body], dim=-1).to(torch.complex64)


def prach_td_rx(cfg: PrachTdConfig, rx: torch.Tensor) -> dict:
    """(B, n_rx, >= n_samples) samples -> detection dict (see prach_rx): CP
    removal, an FFT per repetition, their coherent mean, the L_RA bins, then
    the frequency-domain correlator."""
    body = rx[..., cfg.cp_samples: cfg.cp_samples + cfg.n_rep * cfg.n_fft]
    reps = body.reshape(*body.shape[:-1], cfg.n_rep, cfg.n_fft)
    spec = torch.fft.fft(reps, dim=-1) / np.sqrt(cfg.n_fft)
    spec = torch.mean(spec, dim=-2)                        # coherent combine
    return prach_rx(cfg.freq_cfg(), spec[..., cfg.k0: cfg.k0 + cfg.l_ra])
