"""polartest equivalent: polar codec BLER test (PBCH/DCI/UCI paths).

Port of openairinterface5g_tpu/sim/polartest.py (polartest.c): encode
random payloads with their CRC, BPSK + AWGN, CRC-aided SCL decode, BLER per
SNR point.  CI operating points: PBCH/DCI BLER = 0 at low-rate points, UCI
at -2 dB (test_case_list.xml:96-110).

Usage: python -m openairinterface5g_tpu_torch.sim.polartest -q            # PBCH
       python -m openairinterface5g_tpu_torch.sim.polartest -c -k 40 -E 108  # DCI
       python -m openairinterface5g_tpu_torch.sim.polartest -u -k 16 -E 240  # UCI
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..coding import polar
from ..coding.crc import CRC_POLYS, crc_attach
from . import device_name, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="polar codec test (polartest analog)")
    ap.add_argument("-q", "--pbch", action="store_true")
    ap.add_argument("-c", "--dci", action="store_true")
    ap.add_argument("-u", "--uci", action="store_true")
    ap.add_argument("-k", "--payload-bits", type=int, default=32)
    ap.add_argument("-E", "--encoded-bits", type=int, default=864)
    ap.add_argument("-s", "--snr0", type=float, default=-2.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=0.5)
    ap.add_argument("-n", "--n-trials", type=int, default=100)
    ap.add_argument("-L", "--list-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def code(args) -> tuple[int, str, polar.PolarParams, str]:
    """(payload bits A, CRC name, polar parameters, 'PBCH'|'DCI'|'UCI')."""
    if args.pbch:
        A, E, crc_name, n_max, i_il, n_pc, i_bil = 32, 864, "24C", 9, True, 0, False
    elif args.uci:
        A, E = args.payload_bits, args.encoded_bits
        crc_name, n_pc = ("11", 0) if A >= 20 else ("6", 3)
        n_max, i_il, i_bil = 10, False, True
    else:  # DCI
        A, E, crc_name, n_max, i_il, n_pc, i_bil = (args.payload_bits, args.encoded_bits,
                                                    "24C", 9, True, 0, False)
    K = A + CRC_POLYS[crc_name][0]
    p = polar.polar_params(K=K, E=E, n_max=n_max, i_il=i_il, n_pc=n_pc, n_pc_wm=0, i_bil=i_bil)
    return A, crc_name, p, "PBCH" if args.pbch else ("UCI" if args.uci else "DCI")


def trial(p: polar.PolarParams, crc_name: str, payload: torch.Tensor, noise: torch.Tensor,
          snr_db: float, list_size: int = 8) -> torch.Tensor:
    """One batch: (B, A) payload, (B, E) unit normal noise -> (B,) block
    errors (CRC failed or payload wrong) after BPSK at snr_db."""
    enc = polar.encode(p, crc_attach(payload, crc_name))
    tx = 1.0 - 2.0 * enc.to(torch.float32)
    sigma = 10 ** (-snr_db / 20)
    y = tx + sigma * noise
    bits, ok = polar.decode_with_crc(p, 2 * y / sigma ** 2, crc_name, list_size=list_size)
    return ~ok | torch.any(bits != payload, dim=-1)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    A, crc_name, p, mode = code(args)
    print(f"polar test ({mode}): A={A} K={p.K} E={p.E} N={p.N} mode={p.mode} "
          f"L={args.list_size}")
    print(f"device: {device_name(dev)}")

    batch = min(args.n_trials, 16)
    gen = torch.Generator(device=dev)
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    all_zero = True
    for snr in np.arange(args.snr0, snr1 + 1e-9, args.snr_step):
        rng = np.random.default_rng(3)
        n_err = n_done = 0
        t0 = time.time()
        while n_done < args.n_trials:
            gen.manual_seed(int(rng.integers(1 << 30)))
            payload = torch.randint(0, 2, (batch, A), generator=gen, device=dev,
                                    dtype=torch.int8)
            noise = torch.randn((batch, p.E), generator=gen, device=dev)
            errs = trial(p, crc_name, payload, noise, float(snr), args.list_size).cpu()
            take = min(batch, args.n_trials - n_done)
            n_err += int(errs[:take].sum())
            n_done += take
        print(f"SNR {snr:.2f} dB: BLER {n_err/n_done:.6f} ({n_err}/{n_done}) "
              f"in {time.time()-t0:.1f}s")
        if n_err:
            all_zero = False
    return 0 if all_zero else 1


if __name__ == "__main__":
    sys.exit(main())
