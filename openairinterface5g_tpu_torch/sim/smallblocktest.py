"""smallblocktest equivalent: (32, K) Reed-Muller UCI codec BLER test.

Port of openairinterface5g_tpu/sim/smallblocktest.py (smallblocktest.c):
for each payload size K in 3..11 (or one -k), encode random payloads, BPSK +
AWGN sweep, ML-decode (small_block.decode correlates with all 2^K
codewords), report the BLER per SNR point.

Usage: python -m openairinterface5g_tpu_torch.sim.smallblocktest -s -2 -S 2 -n 1000
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..coding import small_block
from . import device_name, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="small block (RM 32,K) test")
    ap.add_argument("-k", "--payload-bits", type=int, default=0,
                    help="single K to test (default: sweep 3..11)")
    ap.add_argument("-s", "--snr0", type=float, default=-2.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def trial(payload: torch.Tensor, noise: torch.Tensor, snr_db: float) -> torch.Tensor:
    """One batch: (B, K) payload, (B, 32) unit normal noise -> (B,) block
    errors after BPSK at snr_db."""
    tx = 1.0 - 2.0 * small_block.encode(payload).to(torch.float32)
    sigma = 10 ** (-snr_db / 20)
    y = tx + sigma * noise
    bits = small_block.decode(2 * y / sigma ** 2, payload.shape[-1])
    return torch.any(bits != payload, dim=-1)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    ks = [args.payload_bits] if args.payload_bits else list(range(3, 12))
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    batch = min(args.n_trials, 256)
    gen = torch.Generator(device=dev)
    worst = 0.0
    for K in ks:
        for snr in np.arange(args.snr0, snr1 + 1e-9, args.snr_step):
            rng = np.random.default_rng(5)
            n_err = n_done = 0
            t0 = time.time()
            while n_done < args.n_trials:
                gen.manual_seed(int(rng.integers(1 << 30)))
                payload = torch.randint(0, 2, (batch, K), generator=gen, device=dev,
                                        dtype=torch.int8)
                noise = torch.randn((batch, 32), generator=gen, device=dev)
                errs = trial(payload, noise, float(snr)).cpu()
                take = min(batch, args.n_trials - n_done)
                n_err += int(errs[:take].sum())
                n_done += take
            bler = n_err / n_done
            worst = max(worst, bler)
            print(f"K {K:2d}  SNR {snr:6.2f} dB: BLER {bler:.6f} "
                  f"({n_err}/{n_done}) in {time.time()-t0:.1f}s")
    print("Small block test OK" if worst == 0.0 else f"Small block worst BLER {worst:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
