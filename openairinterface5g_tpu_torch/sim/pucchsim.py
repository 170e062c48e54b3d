"""nr_pucchsim equivalent: PUCCH formats 0-4 ACK-miss / BLER simulator.

Port of openairinterface5g_tpu/sim/pucchsim.py (pucchsim.c): random UCI
through one format's TX, a flat channel per trial (AWGN with a random phase,
or flat Rayleigh with --fading) and its RX.  As the reference (pucchsim.c:
537,736), the sweep goes up from snr0 and passes at the first SNR whose
error rate meets the target.  CI points (test_case_list.xml:279-323): F0
1-2 bit at -2 dB; F2 3-11 bit at 0-6 dB; F2 12-64 bit at -3 dB.

Usage: python -m openairinterface5g_tpu_torch.sim.pucchsim -f 0 -b 1 -s -2 -n 1000
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..models.pucch import (Pucch0Config, Pucch1Config, Pucch2Config, Pucch34Config,
                            pucch0_rx, pucch0_tx, pucch1_rx, pucch1_tx, pucch2_rx, pucch2_tx,
                            pucch34_rx, pucch34_tx)
from . import device_name, resolve_device
from .channel import _complex_normal, flat_gain


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="PUCCH simulator (nr_pucchsim analog)")
    ap.add_argument("-f", "--format", type=int, default=0, choices=[0, 1, 2, 3, 4])
    ap.add_argument("-b", "--n-bits", type=int, default=1)
    ap.add_argument("-P", "--n-prb", type=int, default=4)
    ap.add_argument("-s", "--snr0", type=float, default=-2.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=256)
    ap.add_argument("-y", "--n-rx", type=int, default=1)
    ap.add_argument("--fading", action="store_true",
                    help="flat Rayleigh per trial (default: AWGN+phase)")
    ap.add_argument("-t", "--target", type=float, default=0.01,
                    help="pass criterion: error rate below this")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def config(args):
    """The format's configuration, as the JAX simulator builds it."""
    if args.format == 0:
        return Pucch0Config(n_bits=args.n_bits, n_symbols=1)
    if args.format == 1:
        return Pucch1Config(n_bits=args.n_bits, n_symbols=14)
    if args.format == 2:
        return Pucch2Config(n_bits=args.n_bits, n_prb=args.n_prb)
    return Pucch34Config(fmt=args.format, n_bits=args.n_bits,
                         n_prb=args.n_prb if args.format == 3 else 1, n_symbols=14)


def header(args, cfg) -> str:
    if args.format == 0:
        return f"PUCCH F0 sim: {args.n_bits} bits, n_rx={args.n_rx}"
    if args.format == 1:
        return f"PUCCH F1 sim: {args.n_bits} bits 14 syms, n_rx={args.n_rx}"
    if args.format == 2:
        return f"PUCCH F2 sim: {args.n_bits} bits {args.n_prb} PRB, n_rx={args.n_rx}"
    return (f"PUCCH F{args.format} sim: {args.n_bits} bits {cfg.n_prb} PRB 14 syms, "
            f"n_rx={args.n_rx}")


def _tx_rx(cfg):
    if isinstance(cfg, Pucch0Config):
        return pucch0_tx, pucch0_rx
    if isinstance(cfg, Pucch1Config):
        return pucch1_tx, pucch1_rx
    if isinstance(cfg, Pucch2Config):
        return pucch2_tx, pucch2_rx
    return pucch34_tx, pucch34_rx


def draw_uci(cfg, batch: int, gen: torch.Generator) -> torch.Tensor:
    """F0/F1: (B,) values in [0, 2^n_bits); F2-F4: (B, n_bits) bits."""
    if isinstance(cfg, (Pucch0Config, Pucch1Config)):
        return torch.randint(0, 1 << cfg.n_bits, (batch,), generator=gen, device=gen.device)
    return torch.randint(0, 2, (batch, cfg.n_bits), generator=gen, device=gen.device,
                         dtype=torch.int8)


def trial(cfg, uci: torch.Tensor, h: torch.Tensor, noise: torch.Tensor,
          snr_db: float) -> torch.Tensor:
    """One batch: UCI, (B, n_rx, 1, 1) channel, (B, n_rx, *TX shape)
    unit-power complex noise -> (B,) errors (wrong value, or for F2-F4 a
    failed CRC / confidence or wrong bits) at snr_db."""
    tx_fn, rx_fn = _tx_rx(cfg)
    rx = (h * tx_fn(cfg, uci)[:, None] + 10 ** (-snr_db / 20) * noise).to(torch.complex64)
    if uci.dim() == 1:
        got, _ = rx_fn(cfg, rx)
        return got != uci
    got, ok = rx_fn(cfg, rx)
    return ~ok | torch.any(got != uci, dim=-1)


def tx_shape(cfg) -> tuple:
    """The TX grid's shape after the batch dimension."""
    if isinstance(cfg, (Pucch0Config, Pucch1Config)):
        return (cfg.n_symbols, 12)
    if isinstance(cfg, Pucch2Config):
        return (cfg.n_symbols, 12 * cfg.n_prb)
    return (cfg.n_symbols, cfg.msc)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config(args)
    batch = min(args.n_trials, 64)
    print(header(args, cfg))
    print(f"device: {device_name(dev)}")
    gen = torch.Generator(device=dev)
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    passed = False
    for snr in np.arange(args.snr0, snr1 + 1e-9, args.snr_step):
        rng = np.random.default_rng(23)
        n_err = n_done = 0
        t0 = time.time()
        while n_done < args.n_trials:
            gen.manual_seed(int(rng.integers(1 << 30)))
            uci = draw_uci(cfg, batch, gen)
            h = flat_gain(gen, (batch, args.n_rx, 1, 1), args.fading)
            noise = _complex_normal(gen, (batch, args.n_rx, *tx_shape(cfg))) / np.sqrt(2)
            errs = trial(cfg, uci, h, noise, float(snr)).cpu()
            take = min(batch, args.n_trials - n_done)
            n_err += int(errs[:take].sum())
            n_done += take
        rate = n_err / n_done
        print(f"SNR {snr:.2f} dB: UCI error rate {rate:.6f} ({n_err}/{n_done}) "
              f"in {time.time()-t0:.1f}s")
        if rate <= args.target:
            passed = True
            break
    print("PUCCH test OK" if passed else "PUCCH test NOK")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
