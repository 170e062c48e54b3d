"""LTE PUSCH (SC-FDMA) BLER simulator (the reference's ulsim,
openair1/SIMULATION/LTE_PHY/ulsim.c).

Port of openairinterface5g_tpu/sim/lte_ulsim.py, with its flags, lines and
pass string ("LTE PUSCH test OK"), through lte_dlsim's sweep on the PUSCH.

Usage: python -m openairinterface5g_tpu_torch.sim.lte_ulsim -m 16 -R 25 -s 12 -n 64
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..lte.pusch import LtePuschConfig
from . import device_name, resolve_device
from .lte_dlsim import run_sweep


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="LTE PUSCH simulator (ulsim analog)")
    ap.add_argument("-m", "--mcs", type=int, default=16)
    ap.add_argument("-R", "--n-rb", type=int, default=25)
    ap.add_argument("-s", "--snr0", type=float, default=12.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=64)
    ap.add_argument("-b", "--batch", type=int, default=None)
    ap.add_argument("-y", "--n-rx", type=int, default=1)
    ap.add_argument("-g", "--channel", default="AWGN",
                    choices=["AWGN", "EPA", "EVA", "ETU", "TDLA", "TDLB", "TDLC"])
    ap.add_argument("-M", "--max-rounds", type=int, default=1)
    ap.add_argument("-I", "--n-iters", type=int, default=6)
    ap.add_argument("-t", "--eff-tp-check", type=float, default=70.0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = LtePuschConfig(n_rb=args.n_rb, n_prb=args.n_rb, mcs=args.mcs, n_rx=args.n_rx)
    print(f"LTE PUSCH sim: {args.n_rb} PRB MCS {args.mcs} (Qm={cfg.qm}) "
          f"TBS {cfg.tbs} C={cfg.seg().C} channel={args.channel}")
    print(f"device: {device_name(dev)}")
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    snrs = np.arange(args.snr0, snr1 + 1e-9, args.snr_step)
    batch = args.batch or max(1, min(32, args.n_trials))
    results, ok = run_sweep(cfg, snrs, args.n_trials, batch, max_rounds=args.max_rounds,
                            n_iters=args.n_iters, channel=args.channel,
                            eff_tp_check=args.eff_tp_check, uplink=True, device=dev)
    if args.json:
        print(json.dumps(results))
    print("LTE PUSCH test OK" if ok else "LTE PUSCH test NOK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
