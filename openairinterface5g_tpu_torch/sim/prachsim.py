"""nr_prachsim equivalent: PRACH detection simulator over the CI matrix.

Port of openairinterface5g_tpu/sim/prachsim.py (prachsim.c): 8 CI configs
at -30 dB incl. 120 kHz short formats and the high-speed restricted set
(test_case_list.xml:491-513).  The SNR is prachsim.c:721's: noise per
time-domain sample at the carrier sample rate, sigma2_dB = tx_lev_dB - SNR
- 10log10(12*N_RB/N_ZC), the preamble's correlation gain over the band
making -30 dB detectable.  The sweep goes up from snr0 and passes at the
first SNR whose miss rate meets the target (prachsim.c:710,805).

Usage:
  python -m openairinterface5g_tpu_torch.sim.prachsim -a -s -30 -n 100 -p 63 -R 106
  python -m openairinterface5g_tpu_torch.sim.prachsim -a -s -30 -n 100 -R 66 -m 3 -c 52 -H
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import fft_size_for_rb
from ..models.prach import (PrachTdConfig, cyclic_shifts, get_ncs, nr_roots, prach_td_rx,
                            prach_td_tx)
from . import device_name, resolve_device
from .channel import _complex_normal, flat_gain


def _format_from_config(config_index: int, mu: int) -> str:
    """prach_ConfigurationIndex -> preamble format for the rows the reference
    CI uses (38.211 Tables 6.3.3.2-3 FR1 / 6.3.3.2-4 FR2, reduced to the
    long-format ranges and the CI rows)."""
    if mu == 3:                        # FR2 table: the CI's row 52 and the rest
        return "A2"
    if config_index < 28:
        return "0"
    if config_index < 34:
        return "1"
    if config_index < 40:
        return "2"
    if config_index < 67:
        return "3"
    return "A2"                        # FR1 short formats: the CI's row 98 and the rest


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="PRACH simulator (nr_prachsim analog)")
    ap.add_argument("-a", "--awgn", action="store_true",
                    help="AWGN (no fading) — reference -a flag")
    ap.add_argument("-s", "--snr0", type=float, default=-30.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=2.0)
    ap.add_argument("-n", "--n-trials", type=int, default=100)
    ap.add_argument("-y", "--n-rx", type=int, default=1)
    ap.add_argument("-R", "--n-rb", type=int, default=106,
                    help="UL bandwidth in PRBs (sets the sample rate)")
    ap.add_argument("-m", "--mu", type=int, default=1,
                    help="numerology (3 selects the FR2 config table)")
    ap.add_argument("-c", "--config-index", type=int, default=98,
                    help="prach_ConfigurationIndex (selects the format)")
    ap.add_argument("-Z", "--ncs-config", type=int, default=13,
                    help="zeroCorrelationZoneConfig (0-15)")
    ap.add_argument("-H", "--high-speed", action="store_true",
                    help="restricted set type A (long formats)")
    ap.add_argument("-p", "--preamble", type=int, default=None,
                    help="fixed preamble index to transmit (default: random)")
    ap.add_argument("-r", "--root-seq-index", type=int, default=1)
    ap.add_argument("--format", type=str, default=None,
                    help="override the preamble format (0-3, A1..B4)")
    ap.add_argument("--fading", action="store_true", help="flat Rayleigh per trial")
    ap.add_argument("-t", "--target", type=float, default=0.01,
                    help="pass: miss-detection rate below this")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def config(args) -> tuple[PrachTdConfig, int]:
    """(the occasion, its preamble count up to 64): enough successive
    logical roots for 64 preambles (at most 400 more)."""
    fmt = args.format or _format_from_config(args.config_index, args.mu)
    restricted = 1 if args.high_speed and fmt in "0123" else 0
    n_cs = get_ncs(args.ncs_config, fmt, restricted)
    l_ra = 839 if fmt in "0123" else 139
    fs = fft_size_for_rb(args.n_rb) * 15e3 * (1 << args.mu)
    roots, logical = [], args.root_seq_index
    while True:
        roots.append(nr_roots(logical, 1, l_ra)[0])
        total = sum(len(cyclic_shifts(u, l_ra, n_cs, restricted)) for u in roots)
        if total >= 64 or logical - args.root_seq_index > 400:
            break
        logical += 1
    cfg = PrachTdConfig(fmt=fmt, mu=args.mu, sample_rate=fs, roots=tuple(roots), n_cs=n_cs,
                        threshold=8.0, restricted=restricted)
    n_pre = min(64, cfg.freq_cfg().n_preambles)
    if n_pre <= 0:
        raise ValueError("no preambles available for this config")
    return cfg, n_pre


def trial(cfg: PrachTdConfig, pre: torch.Tensor, h: torch.Tensor, noise: torch.Tensor,
          snr_db: float, n_rb: int) -> torch.Tensor:
    """One batch: (B,) preambles, (B, n_rx, 1) channel, (B, n_rx, n_samples)
    complex noise of unit variance per component -> (B,) misses (not
    detected, or another preamble) at snr_db (prachsim.c:721's scale)."""
    tx = prach_td_tx(cfg, pre)                             # (B, n_samples)
    tx_lev = torch.mean(tx.abs() ** 2)
    sigma2 = tx_lev * 10 ** (-snr_db / 10) / (12 * n_rb / cfg.l_ra)
    rx = (h * tx[:, None] + torch.sqrt(sigma2 / 2) * noise).to(torch.complex64)
    out = prach_td_rx(cfg, rx)
    return ~out["detected"] | (out["preamble"] != pre)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, n_pre = config(args)
    batch = min(args.n_trials, 32)
    print(f"PRACH sim: fmt {cfg.fmt} L_RA={cfg.l_ra} N_cs={cfg.n_cs} "
          f"restricted={cfg.restricted} {len(cfg.roots)} roots ({n_pre} preambles) "
          f"fs={cfg.sample_rate/1e6:.2f} MHz n_rx={args.n_rx}")
    print(f"device: {device_name(dev)}")
    gen = torch.Generator(device=dev)
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    passed = False
    for snr in np.arange(args.snr0, snr1 + 1e-9, args.snr_step):
        rng = np.random.default_rng(31)
        n_err = n_done = 0
        t0 = time.time()
        while n_done < args.n_trials:
            gen.manual_seed(int(rng.integers(1 << 30)))
            if args.preamble is not None:
                pre = torch.full((batch,), min(args.preamble, n_pre - 1), device=dev)
            else:
                pre = torch.randint(0, n_pre, (batch,), generator=gen, device=dev)
            h = flat_gain(gen, (batch, args.n_rx, 1), args.fading)
            noise = _complex_normal(gen, (batch, args.n_rx, cfg.n_samples))
            errs = trial(cfg, pre, h, noise, float(snr), args.n_rb).cpu()
            take = min(batch, args.n_trials - n_done)
            n_err += int(errs[:take].sum())
            n_done += take
        rate = n_err / n_done
        print(f"SNR {snr:.2f} dB: miss rate {rate:.6f} ({n_err}/{n_done}) "
              f"in {time.time()-t0:.1f}s")
        if rate <= args.target:
            passed = True
            break
    print("PRACH test OK" if passed else "PRACH test NOK")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
