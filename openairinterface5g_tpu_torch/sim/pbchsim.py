"""nr_pbchsim equivalent: PBCH/SSB BLER simulator.

Port of openairinterface5g_tpu/sim/pbchsim.py (pbchsim.c): SSB tiles of
random payloads over AWGN with a random phase (or flat Rayleigh with
--fading), received and SCL-decoded; pass when the BLER is below the target
at every SNR.  CI points: pass at SNR -11..-8 dB (test_case_list.xml:
112-148).

Usage: python -m openairinterface5g_tpu_torch.sim.pbchsim -s -8 -n 100
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..models.pbch import PbchConfig, ssb_generate, ssb_receive
from . import device_name, resolve_device
from .channel import _complex_normal, flat_gain


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="PBCH BLER simulator (nr_pbchsim analog)")
    ap.add_argument("-s", "--snr0", type=float, default=-8.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=100)
    ap.add_argument("-y", "--n-rx", type=int, default=1)
    ap.add_argument("-I", "--cell-id", type=int, default=0)
    ap.add_argument("-L", "--list-size", type=int, default=8)
    ap.add_argument("-t", "--target-bler", type=float, default=0.1,
                    help="pass criterion: BLER below this at every SNR")
    ap.add_argument("--fading", action="store_true",
                    help="per-trial flat Rayleigh fading (default: AWGN+phase)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def trial(cfg: PbchConfig, payload: torch.Tensor, h: torch.Tensor, noise: torch.Tensor,
          snr_db: float, list_size: int = 8) -> torch.Tensor:
    """One batch: (B, 32) payload, (B, n_rx, 1, 1) channel, (B, n_rx, 4, 240)
    unit-power complex noise -> (B,) block errors at snr_db."""
    tile = ssb_generate(cfg, payload)
    rx = h * tile[:, None] + 10 ** (-snr_db / 20) * noise
    bits, ok = ssb_receive(cfg, rx.to(torch.complex64), list_size=list_size)
    return ~ok | torch.any(bits != payload, dim=-1)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = PbchConfig(n_id=args.cell_id, i_ssb=0)
    batch = min(args.n_trials, 16)
    print(f"PBCH sim: cell {args.cell_id} E=864 N=512 SCL{args.list_size} n_rx={args.n_rx}")
    print(f"device: {device_name(dev)}")
    gen = torch.Generator(device=dev)
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    ok_all = True
    for snr in np.arange(args.snr0, snr1 + 1e-9, args.snr_step):
        rng = np.random.default_rng(11)
        n_err = n_done = 0
        t0 = time.time()
        while n_done < args.n_trials:
            gen.manual_seed(int(rng.integers(1 << 30)))
            payload = torch.randint(0, 2, (batch, 32), generator=gen, device=dev,
                                    dtype=torch.int8)
            h = flat_gain(gen, (batch, args.n_rx, 1, 1), args.fading)
            noise = _complex_normal(gen, (batch, args.n_rx, 4, 240)) / np.sqrt(2)
            errs = trial(cfg, payload, h, noise, float(snr), args.list_size).cpu()
            take = min(batch, args.n_trials - n_done)
            n_err += int(errs[:take].sum())
            n_done += take
        bler = n_err / n_done
        print(f"SNR {snr:.2f} dB: PBCH BLER {bler:.6f} ({n_err}/{n_done}) in "
              f"{time.time()-t0:.1f}s")
        if bler > args.target_bler:
            ok_all = False
    print("PBCH test OK" if ok_all else "PBCH test NOK")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
