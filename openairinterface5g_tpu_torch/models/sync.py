"""UE initial synchronization: PSS/SSS search + cell id + CFO.

Port of openairinterface5g_tpu/models/sync.py.  The PSS search is one
batched FFT cross-correlation of the sample stream against the 3
time-domain PSS replicas; the SSS identification correlates against the
336 candidates of the detected N_ID2.  Time axes are float32, as there.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FrameParams
from ..phy import refsig

SSB_SC = 240


def _ssb_bins(fp: FrameParams, k_offset: int, first: int, n: int) -> np.ndarray:
    """FFT bins of SSB subcarriers first..first+n-1 (SSB centred at DC +
    k_offset)."""
    start = (fp.fft_size - SSB_SC) // 2 + k_offset
    return (start + first + np.arange(n) - fp.fft_size // 2) % fp.fft_size


def ssb_time_signal(fp: FrameParams, tile: torch.Tensor, k_offset: int = 0) -> torch.Tensor:
    """(B, 4, 240) SSB tile centred in band, the 4 symbols OFDM-modulated
    with no CP, contiguous -> (B, 4*fft) time samples (the sync sims'
    simplified mapping)."""
    B = tile.shape[0]
    grid = torch.zeros((B, 4, fp.fft_size), dtype=torch.complex64, device=tile.device)
    grid[:, :, torch.as_tensor(_ssb_bins(fp, k_offset, 0, SSB_SC), device=tile.device)] = tile
    x = torch.fft.ifft(grid, dim=-1) * np.sqrt(fp.fft_size)
    return x.reshape(B, 4 * fp.fft_size).to(torch.complex64)


@functools.lru_cache(maxsize=16)
def _pss_replicas(fft_size: int, k_offset: int = 0) -> np.ndarray:
    """(3, fft) time-domain PSS replicas for correlation."""
    out = np.zeros((3, fft_size), np.complex64)
    start = (fft_size - SSB_SC) // 2 + k_offset
    for nid2 in range(3):
        grid = np.zeros(fft_size, np.complex64)
        bins = (start + 56 + np.arange(127) - fft_size // 2) % fft_size
        grid[bins] = refsig.pss_sequence(nid2)
        out[nid2] = np.fft.ifft(grid) * np.sqrt(fft_size)
    return out


@functools.lru_cache(maxsize=16)
def _replicas_on(fft_size: int, k_offset: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_pss_replicas(fft_size, k_offset), device=device)


@functools.lru_cache(maxsize=4)
def _sss_table(device: torch.device) -> torch.Tensor:
    """(3, 336, 127) complex64: every SSS by (N_ID2, N_ID1)."""
    t = np.stack([np.stack([refsig.sss_sequence(n1, n2) for n1 in range(336)])
                  for n2 in range(3)])
    return torch.as_tensor(t, dtype=torch.complex64, device=device)


def pss_search(fp: FrameParams, samples: torch.Tensor, k_offset: int = 0):
    """(B, n_samples) stream -> (t0 (B,), n_id2 (B,), metric (B,)) by FFT
    cross-correlation against the 3 PSS replicas over the valid lags."""
    B, n = samples.shape
    reps = _replicas_on(fp.fft_size, k_offset, samples.device)
    nfft = int(2 ** np.ceil(np.log2(n + fp.fft_size)))
    S = torch.fft.fft(samples, n=nfft, dim=-1)
    P = torch.fft.fft(reps, n=nfft, dim=-1)
    corr = torch.fft.ifft(S[:, None, :] * torch.conj(P)[None], dim=-1)
    n_lags = n - fp.fft_size + 1
    flat = (corr[..., :n_lags].abs() ** 2).reshape(B, -1)
    best = torch.argmax(flat, dim=-1)
    metric = flat.amax(dim=-1) / (torch.mean(flat, dim=-1) + 1e-12)
    return (best % n_lags).to(torch.int32), (best // n_lags).to(torch.int32), metric


def sss_identify(sss_re: torch.Tensor, n_id2: torch.Tensor):
    """(B, 127) SSS REs + (B,) n_id2 -> (n_id1 (B,), metric): coherent
    correlation with the 336 candidates of the detected n_id2."""
    cand = _sss_table(sss_re.device)[n_id2.long()]                  # (B, 336, 127)
    corr = torch.einsum("bk,bnk->bn", sss_re, cand.to(sss_re.dtype)).abs() ** 2
    n_id1 = torch.argmax(corr, dim=-1).to(torch.int32)
    energy = torch.sum(sss_re.abs() ** 2, dim=-1) * 127
    return n_id1, corr.amax(dim=-1) / (energy + 1e-12)


def timing_drift_estimate(h_freq: torch.Tensor) -> torch.Tensor:
    """Signed timing offset (samples at the estimate's subcarrier span) from
    the channel impulse response's strongest tap."""
    g = torch.fft.ifft(h_freq, dim=-1)
    n = g.shape[-1]
    peak = torch.argmax(g.abs() ** 2, dim=-1).to(torch.int32)
    return torch.where(peak > n // 2, peak - n, peak)


def _time_axis(fp: FrameParams, n: int, device: torch.device) -> torch.Tensor:
    """(n,) float32 sample times arange(n) / fs, the JAX model's float32 axis."""
    return torch.arange(n, device=device, dtype=torch.float32) / np.float32(fp.sample_rate)


def _derotate(samples: torch.Tensor, cfo_hz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """samples * exp(-j 2 pi cfo t), the phase in float32 and associated as
    in the JAX model ((-2 pi cfo) t)."""
    ph = ((-2 * np.pi) * cfo_hz)[:, None] * t[None]             # (B, n) float32
    return samples * torch.polar(torch.ones_like(ph), ph)


def compensate_cfo(fp: FrameParams, samples: torch.Tensor, cfo_hz) -> torch.Tensor:
    """Derotate a (B, n) stream by exp(-j*2*pi*cfo*t); cfo_hz: scalar or (B,)."""
    cfo = torch.as_tensor(cfo_hz, dtype=torch.float32, device=samples.device)
    if cfo.dim() == 0:
        cfo = cfo[None]
    return _derotate(samples, cfo, _time_axis(fp, samples.shape[-1], samples.device))


def estimate_cfo_pss(fp: FrameParams, samples: torch.Tensor, t0, n_id2,
                     k_offset: int = 0) -> torch.Tensor:
    """Fractional CFO (Hz) from the PSS half-symbol phase ramp: the two
    halves' correlations with the replica differ by 2*pi*eps*T/2; range
    +-1 subcarrier spacing."""
    reps = _replicas_on(fp.fft_size, k_offset, samples.device)
    idx = t0.long()[:, None] + torch.arange(fp.fft_size, device=samples.device)[None]
    prod = torch.gather(samples, 1, idx) * torch.conj(reps[n_id2.long()])
    half = fp.fft_size // 2
    c1 = torch.sum(prod[..., :half], dim=-1)
    c2 = torch.sum(prod[..., half:], dim=-1)
    dphi = torch.angle(c2 * torch.conj(c1))
    return dphi / (2 * np.pi) * fp.sample_rate / half


def initial_sync(fp: FrameParams, samples: torch.Tensor, k_offset: int = 0,
                 cfo_scan: int = 0) -> dict:
    """Full sync from a (B, n) stream holding one SSB (4 contiguous symbols,
    no CP): PSS timing, SSS cell id.

    cfo_scan > 0 recovers a carrier frequency offset within +-cfo_scan
    subcarrier spacings: every integer-SCS hypothesis is a derotated copy
    stacked on the batch axis through one correlation, then the fractional
    part comes from the PSS half-symbol phase and the stream is derotated
    before the SSS.  Returns dict(t0, n_id, pss_metric, sss_metric, cfo_hz,
    samples_corrected).
    """
    B, n = samples.shape
    dev = samples.device
    cfo_est = torch.zeros((B,), dtype=torch.float32, device=dev)
    work = samples
    if cfo_scan > 0:
        hyp = torch.as_tensor(np.arange(-cfo_scan, cfo_scan + 1, dtype=np.float32) * fp.scs,
                              device=dev)
        H = hyp.shape[0]
        rot = _derotate(torch.ones((H, n), dtype=torch.complex64, device=dev), hyp,
                        _time_axis(fp, n, dev))
        stack = (samples[:, None, :] * rot[None]).reshape(B * H, n)
        t0h, n2h, mh = pss_search(fp, stack.to(torch.complex64), k_offset)
        best = torch.argmax(mh.reshape(B, H), dim=-1)               # (B,)
        cfo_int = hyp[best]
        pick = best + torch.arange(B, device=dev) * H
        work = compensate_cfo(fp, samples, cfo_int)
        cfo_est = cfo_int + estimate_cfo_pss(fp, work, t0h[pick], n2h[pick], k_offset)
        work = compensate_cfo(fp, samples, cfo_est)
    t0, n_id2, m_pss = pss_search(fp, work, k_offset)
    # the SSS symbol (symbol 2 of the SSB) at the found timing
    idx = t0.long()[:, None] + 2 * fp.fft_size + torch.arange(fp.fft_size, device=dev)[None]
    grid = torch.fft.fft(torch.gather(work, 1, idx), dim=-1) / np.sqrt(fp.fft_size)
    sss_re = grid[..., torch.as_tensor(_ssb_bins(fp, k_offset, 56, 127), device=dev)]
    n_id1, m_sss = sss_identify(sss_re, n_id2)
    return {"t0": t0, "n_id": 3 * n_id1 + n_id2, "pss_metric": m_pss, "sss_metric": m_sss,
            "cfo_hz": cfo_est, "samples_corrected": work}
