"""Channel simulator: AWGN + tapped-delay-line fading.

Port of openairinterface5g_tpu/sim/channel.py: AWGN, TDL-A to E (TS 38.901
Table 7.7.2) and the legacy EPA/EVA/ETU profiles, the HST Doppler phasor,
carrier frequency offset, phase noise and complex AWGN.  The trial is the
leading batch dimension of every tensor.

Randomness comes from an explicit ``torch.Generator`` on the run's device.
``apply_channel`` is the random draw of the taps (``draw_taps``) followed by
a deterministic linear convolution (``convolve_taps``), so a test can feed
the JAX package's own taps to the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Normalized power-delay profiles: (delays at unit delay spread, power dB),
# TS 38.901 Table 7.7.2-1..3; the delays scale by the DS parameter.
TDL_PROFILES = {
    "TDLA": (
        np.array([0.0000, 0.3819, 0.4025, 0.5868, 0.4610, 0.5375, 0.6708,
                  0.5750, 0.7618, 1.5375, 1.8978, 2.2242, 2.1718, 2.4942,
                  2.5119, 3.0582, 4.0810, 4.4579, 4.5695, 4.7966, 5.0066,
                  5.3043, 9.6586]),
        np.array([-13.4, 0.0, -2.2, -4.0, -6.0, -8.2, -9.9, -10.5, -7.5,
                  -15.9, -6.6, -16.7, -12.4, -15.2, -10.8, -11.3, -12.7,
                  -16.2, -18.3, -18.9, -16.6, -19.9, -29.7]),
    ),
    "TDLB": (
        np.array([0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986, 0.3752,
                  0.5055, 0.3681, 0.3697, 0.5700, 0.5283, 1.1021, 1.2756,
                  1.5474, 1.7842, 2.0169, 2.8294, 3.0219, 3.6187, 4.1067,
                  4.2790, 4.7834]),
        np.array([0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2, -7.6,
                  -3.0, -8.9, -9.0, -4.8, -5.7, -7.5, -1.9, -7.6, -12.2,
                  -9.8, -11.4, -14.9, -9.2, -11.3]),
    ),
    "TDLC": (
        np.array([0.0000, 0.2099, 0.2219, 0.2329, 0.2176, 0.6366, 0.6448,
                  0.6560, 0.6584, 0.7935, 0.8213, 0.9336, 1.2285, 1.3083,
                  2.1704, 2.7105, 4.2589, 4.6003, 5.4902, 5.6077, 6.3065,
                  6.6374, 7.0427, 8.6523]),
        np.array([-4.4, -1.2, -3.5, -5.2, -2.5, 0.0, -2.2, -3.9, -7.4,
                  -7.1, -10.7, -11.1, -5.1, -6.8, -8.7, -13.2, -13.9,
                  -13.9, -15.8, -17.1, -16.0, -15.7, -21.6, -22.8]),
    ),
    # LOS (Rician) models: tap 0 also carries the specular component of
    # LOS_COMPONENT (TS 38.901 Tables 7.7.2-4/5)
    "TDLD": (
        np.array([0.0000, 0.0350, 0.6120, 1.3630, 1.4050, 1.8040, 2.5960,
                  1.7750, 4.0420, 7.9370, 9.4240, 9.7080, 12.5250]),
        np.array([-13.5, -18.8, -21.0, -22.8, -17.9, -20.1, -21.9, -22.9,
                  -27.8, -23.6, -24.8, -30.0, -27.7]),
    ),
    "TDLE": (
        np.array([0.0000, 0.5133, 0.5440, 0.5630, 0.5440, 0.7112, 1.9092,
                  1.9293, 1.9589, 2.6426, 3.7136, 5.4524, 12.0034, 20.6419]),
        np.array([-22.03, -15.8, -18.1, -19.8, -22.9, -22.4, -18.6, -21.2,
                  -22.8, -22.9, -25.9, -28.6, -29.8, -30.0]),
    ),
}

# power (dB) of the deterministic specular component of the LOS models' tap 0
LOS_COMPONENT = {
    "TDLD": -0.2,
    "TDLE": -0.03,
}

# 3GPP TS 36.101 legacy profiles: absolute delays in ns, powers in dB
LEGACY_PROFILES = {
    "EPA": (np.array([0, 30, 70, 90, 110, 190, 410], dtype=np.float64),
            np.array([0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8])),
    "EVA": (np.array([0, 30, 150, 310, 370, 710, 1090, 1730, 2510], dtype=np.float64),
            np.array([0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9])),
    "ETU": (np.array([0, 50, 120, 200, 230, 500, 1600, 2300, 5000], dtype=np.float64),
            np.array([-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0])),
}

# the legacy profiles register beside the normalized ones, their delays in
# us, i.e. normalized to a delay spread of 1000 ns
for _name, (_d, _p) in LEGACY_PROFILES.items():
    TDL_PROFILES[_name] = (_d / 1000.0, _p)


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Static channel description."""

    name: str               # 'AWGN' | 'TDLA'..'TDLE' | 'EPA'|'EVA'|'ETU'
    n_tx: int
    n_rx: int
    sample_rate: float
    delay_spread_ns: float = 30.0   # DS scaling for TDL profiles
    max_doppler_hz: float = 0.0     # TS 38.104 G.3-1 HST Doppler trajectory
    center_freq_hz: float = 3.5e9   # carrier (sets v from max_doppler_hz)

    def tap_delays_samples(self) -> np.ndarray:
        if self.name == "AWGN":
            return np.zeros(1, dtype=np.int64)
        d_ns, _ = TDL_PROFILES[self.name]
        return np.round(d_ns * self.delay_spread_ns * 1e-9 * self.sample_rate).astype(np.int64)

    def tap_powers(self) -> np.ndarray:
        """NLOS (Rayleigh) tap powers, normalized so NLOS + LOS sums to 1."""
        if self.name == "AWGN":
            return np.ones(1)
        _, p_db = TDL_PROFILES[self.name]
        p = 10 ** (p_db / 10)
        return p / (p.sum() + self.los_power())

    def los_power(self) -> float:
        """Linear power of the deterministic specular component (0 if NLOS),
        in the same un-normalized scale as 10**(p_db/10) of the taps."""
        if self.name not in LOS_COMPONENT:
            return 0.0
        return float(10 ** (LOS_COMPONENT[self.name] / 10))

    def los_power_normalized(self) -> float:
        if self.name not in LOS_COMPONENT:
            return 0.0
        _, p_db = TDL_PROFILES[self.name]
        p = 10 ** (p_db / 10)
        return self.los_power() / (p.sum() + self.los_power())


def _complex_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Unit-variance-per-component complex normal draws (re + j im)."""
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return torch.complex(re, im)


def flat_gain(gen: torch.Generator, shape, fading: bool) -> torch.Tensor:
    """A flat channel per trial: Rayleigh (complex normal of unit power) with
    `fading`, else a unit phasor of uniform phase (AWGN + phase, the
    control-channel simulators' default), complex64 of `shape`."""
    if fading:
        return _complex_normal(gen, shape) / np.sqrt(2)
    phi = torch.rand(shape, generator=gen, device=gen.device) * (2 * np.pi)
    return torch.polar(torch.ones_like(phi), phi)


def draw_taps(model: ChannelModel, gen: torch.Generator, lead: tuple) -> torch.Tensor:
    """One random channel realization per leading index: the dense FIR
    (*lead, n_rx, n_tx, max_delay+1) complex64 on the generator's device.
    Block fading: the taps are constant over the slot."""
    dev = gen.device
    if model.name == "AWGN":
        eye = torch.eye(model.n_rx, model.n_tx, dtype=torch.complex64, device=dev)
        return eye[..., None].expand(*lead, model.n_rx, model.n_tx, 1)
    delays = model.tap_delays_samples()
    shape = (*lead, model.n_rx, model.n_tx, len(delays))
    g = _complex_normal(gen, shape) / np.sqrt(2)
    g = g * torch.as_tensor(np.sqrt(model.tap_powers()), dtype=torch.float32, device=dev)
    p_los = model.los_power_normalized()
    if p_los > 0.0:
        # Rician tap 0: a specular component with a random phase per
        # antenna pair (TS 38.901 7.7.2-4/5 LOS path)
        phi = torch.rand(shape[:-1], generator=gen, device=dev) * (2 * np.pi)
        g[..., 0] += np.sqrt(p_los) * torch.exp(1j * phi)
    # scatter the taps into a dense FIR; taps that round to one delay add
    h = torch.zeros((*shape[:-1], int(delays.max()) + 1), dtype=torch.complex64, device=dev)
    torch.view_as_real(h).index_add_(-2, torch.as_tensor(delays, device=dev),
                                     torch.view_as_real(g))
    return h


def convolve_taps(h: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """Linear convolution of (..., n_tx, n_samples) with the FIR h
    (..., n_rx, n_tx, L), truncated to the slot: (..., n_rx, n_samples)
    complex64.  One tap is a matrix product; more go through a zero-padded
    FFT of length 2**ceil(log2(n_samples + L))."""
    n_s, L = tx.shape[-1], h.shape[-1]
    x = tx.to(torch.complex64)
    if L == 1:
        return torch.einsum("...rt,...ts->...rs", h[..., 0], x)
    nfft = int(2 ** np.ceil(np.log2(n_s + L)))
    Htap = torch.fft.fft(h, n=nfft, dim=-1)
    Xtap = torch.fft.fft(x, n=nfft, dim=-1)
    Y = torch.einsum("...rtf,...tf->...rf", Htap, Xtap)
    return torch.fft.ifft(Y, dim=-1)[..., :n_s]


def apply_channel(model: ChannelModel, gen: torch.Generator,
                  tx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate (..., n_tx, n_samples) through one random channel realization.

    Returns (rx (..., n_rx, n_samples), h_taps (..., n_rx, n_tx, max_delay+1)).
    """
    h = draw_taps(model, gen, tuple(tx.shape[:-2]))
    return convolve_taps(h, tx), h


def _time_axis(n_samples: int, sample_rate: float, t0: float, device) -> torch.Tensor:
    """(n_samples,) float32 sample times t0 + n / sample_rate."""
    return t0 + torch.arange(n_samples, dtype=torch.float32, device=device) / sample_rate


def doppler_phasor(model: ChannelModel, gen: torch.Generator, n_samples: int,
                   t0: float = 0.0) -> torch.Tensor:
    """(n_samples,) time-varying Doppler phasor, TS 38.104 Table G.3-1.

    A high-speed train passes the site at v = f_D*c/f_c; the instantaneous
    Doppler fs(t) = f_D*cos(theta(t)) follows the piecewise HST trajectory
    with Dmin=2 m, Ds=300 m, and the phasor exp(j(2*pi*fs(t)*t + phi0))
    multiplies the faded signal.  Computed in float32."""
    d_min, d_s = 2.0, 300.0
    c = 299792458.0
    f_d = model.max_doppler_hz
    v = f_d * c / model.center_freq_hz
    t = _time_axis(n_samples, model.sample_rate, t0, gen.device)
    x1 = d_s / 2 - v * t
    x2 = -1.5 * d_s + v * t
    cos1 = x1 / torch.sqrt(d_min * d_min + x1 * x1)
    cos2 = x2 / torch.sqrt(d_min * d_min + x2 * x2)
    cos3 = torch.cos(torch.remainder(t, 2 * d_s / v))
    cos_theta = torch.where(t <= d_s / v, cos1, torch.where(t <= 2 * d_s / v, cos2, cos3))
    phi0 = torch.rand((), generator=gen, device=gen.device) * (2 * np.pi)
    return torch.exp(1j * (2 * np.pi * f_d * cos_theta * t + phi0))


def apply_cfo(rx: torch.Tensor, sample_rate: float, cfo_hz: float,
              t0: float = 0.0, phase0: float = 0.0) -> torch.Tensor:
    """Carrier frequency offset: rx * exp(j(2*pi*cfo*t + phase0)) over the
    last (time) axis."""
    t = _time_axis(rx.shape[-1], sample_rate, t0, rx.device)
    return rx * torch.exp(1j * (2 * np.pi * cfo_hz * t + phase0))


def apply_phase_noise(rx: torch.Tensor, sample_rate: float,
                      fd_hz: float = 300.0, t0: float = 0.0) -> torch.Tensor:
    """The 'linear phase noise model': a 300 Hz continuous rotation applied
    per sample to the received signal."""
    return apply_cfo(rx, sample_rate, fd_hz, t0)


def add_noise(gen: torch.Generator, rx: torch.Tensor, sigma2) -> torch.Tensor:
    """Complex AWGN with per-component variance sigma2/2; sigma2 is a
    number or a 0-dim tensor on rx's device."""
    scale = torch.sqrt(torch.as_tensor(sigma2 / 2, dtype=torch.float32, device=rx.device))
    return rx + scale * _complex_normal(gen, rx.shape)
