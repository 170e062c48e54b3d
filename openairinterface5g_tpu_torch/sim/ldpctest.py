"""ldpctest equivalent: LDPC codec BLER + throughput microbenchmark.

Port of openairinterface5g_tpu/sim/ldpctest.py (ldpctest.c): derive (BG,
Zc) from the block length, encode batches of segments, BPSK + AWGN,
decode with the flooding decoder of ``coding/ldpc.py`` (the JAX tool's
decoder), report BLER and throughput.  CI pass criterion: "BLER 0.000000"
printed at the operating point (test_case_list.xml:68-94: BG1 3872..8448
at 10 dB).

Usage: python -m openairinterface5g_tpu_torch.sim.ldpctest -l 8448 -s 10 -n 100
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..coding import ldpc, rate_matching
from ..coding.segmentation import segment_params
from . import device_name, resolve_device


def derive_params(block_length: int, bg: int | None = None):
    """BG/Kb/Z from block length (ldpctest.c:177-246 logic, per 38.212)."""
    if bg is None:
        bg = 1 if block_length > 3840 else 2
    return segment_params(block_length, bg)


def main(argv=None):
    ap = argparse.ArgumentParser(description="LDPC codec test (ldpctest analog)")
    ap.add_argument("-l", "--block-length", type=int, default=8448)
    ap.add_argument("-s", "--snr", type=float, default=10.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=0.5)
    ap.add_argument("-n", "--n-trials", type=int, default=100)
    ap.add_argument("-b", "--batch", type=int, default=None)
    ap.add_argument("-i", "--n-iters", type=int, default=20)
    ap.add_argument("-r", "--rate", type=float, default=1 / 3,
                    help="code rate via rate matching (1/3 = mother code BG1)")
    ap.add_argument("-g", "--bg", type=int, default=None, choices=[1, 2])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = derive_params(args.block_length, args.bg)
    g = ldpc.build_graph(p.bg, p.Z)
    E = min(int(round(args.block_length / args.rate)), g.N)
    print(f"LDPC test: block {args.block_length} BG{p.bg} Z={p.Z} K={p.K} "
          f"F={p.F} E={E} rate {args.block_length/E:.3f} iters {args.n_iters}")
    print(f"device: {device_name(dev)}")

    batch = args.batch or min(args.n_trials, 32)
    gen = torch.Generator(device=dev)

    def step(snr_db: float) -> torch.Tensor:
        info = torch.randint(0, 2, (batch, p.K), generator=gen, device=dev, dtype=torch.int8)
        # zero the filler region (known bits)
        if p.F:
            info[:, p.K - p.F:] = 0
        cw = ldpc.encode(g, info)
        e = rate_matching.rate_match_tx(g, cw, 0, E, p.F)
        tx = 1.0 - 2.0 * e.to(torch.float32)
        sigma = 10 ** (-snr_db / 20)
        y = tx + sigma * torch.randn(tx.shape, generator=gen, device=dev)
        llr = 2.0 * y / sigma**2
        full = rate_matching.rate_match_rx(g, llr, 0, p.F)
        bits, _, _ = ldpc.decode(g, full, n_iters=args.n_iters)
        return torch.any(bits != info, dim=-1)

    snr1 = args.snr1 if args.snr1 is not None else args.snr
    all_zero = True
    for snr in np.arange(args.snr, snr1 + 1e-9, args.snr_step):
        rng = np.random.default_rng(17)
        n_err = 0
        n_done = 0
        t0 = time.time()
        while n_done < args.n_trials:
            gen.manual_seed(int(rng.integers(1 << 30)))
            errs = step(float(snr))
            take = min(batch, args.n_trials - n_done)
            n_err += int(errs[:take].sum())
            n_done += take
        dt = time.time() - t0
        bler = n_err / n_done
        mbps = args.block_length * n_done / dt / 1e6
        print(f"SNR {snr:.2f} dB: BLER {bler:.6f} ({n_err}/{n_done}), "
              f"decode+encode throughput {mbps:.2f} Mb/s")
        if bler > 0:
            all_zero = False
    return 0 if all_zero else 1


if __name__ == "__main__":
    sys.exit(main())
