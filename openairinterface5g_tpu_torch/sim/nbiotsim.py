"""NB-IoT PHY simulator CLI: NPSS/NSSS sync, NPBCH repetition gain,
NPDSCH/NPUSCH round trips, NPRACH detection, one pass/fail gate.

Port of openairinterface5g_tpu/sim/nbiotsim.py, with its flags and lines.  It
draws every payload and noise sample from one numpy default_rng(0) in the
JAX simulator's order and moves them to the run's device, so it prints the
same lines.

Usage: python -m openairinterface5g_tpu_torch.sim.nbiotsim [-n TRIALS] [--device cuda|cpu]
Prints "NB-IoT test OK" when every stage meets its operating point.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..lte import nbiot
from . import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--n-trials", type=int, default=8)
    ap.add_argument("-s", "--noise", type=float, default=0.6)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    B = args.n_trials
    ok = True

    def noise(shape, s):
        z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
        return s * torch.as_tensor(z, device=dev)

    def bits(shape):
        return torch.as_tensor(rng.integers(0, 2, shape).astype(np.int8), device=dev)

    def host(x):
        return x.cpu().numpy()

    # sync
    g = nbiot.npss_insert(torch.zeros((B, 14, 12), dtype=torch.complex64, device=dev))
    m = host(nbiot.npss_detect(g + noise((B, 14, 12), 0.4)))
    print(f"NPSS detect metric: {m.mean():.2f} (threshold 0.4)")
    ok &= (m > 0.4).all()
    n_id = 133
    g2 = nbiot.nsss_insert(torch.zeros((B, 14, 12), dtype=torch.complex64, device=dev), n_id, 0)
    ids, _ = nbiot.nsss_identify(g2 + noise((B, 14, 12), 0.4), range(120, 150))
    n_sync = int((host(ids) == n_id).sum())
    print(f"NSSS id: {n_sync}/{B}")
    ok &= n_sync == B

    # NPBCH with 8-rep combining
    cfg = nbiot.NbConfig(n_id=n_id, n_reps=8)
    mib = bits((B, nbiot.MIB_NB_BITS))
    tiles = nbiot.npbch_tx(cfg, mib)
    out = nbiot.npbch_rx(cfg, tiles + noise(tiles.shape, 1.2))
    n_mib = int(host(out["ok"]).sum())
    print(f"NPBCH (8 reps @ sigma 1.2): {n_mib}/{B}")
    ok &= n_mib == B

    # NPDSCH / NPUSCH
    for ul in (False, True):
        c = nbiot.NbSchConfig(tbs=256, n_sf=2, n_reps=4, ul=ul)
        t = nbiot.nbsch_tx(c, bits((B, c.tbs)))
        o = nbiot.nbsch_rx(c, t + noise(t.shape, args.noise))
        n = int(host(o["ok"]).sum())
        print(f"{'NPUSCH' if ul else 'NPDSCH'} (4 reps @ sigma {args.noise}): {n}/{B}")
        ok &= n == B

    # NPRACH
    pc = nbiot.NprachConfig()
    det = 0
    for n0 in range(0, 12, 3):
        t = nbiot.nprach_tx(pc, n0, batch=1, device=dev)
        o = nbiot.nprach_detect(pc, t + noise(t.shape, 0.25))
        det += int(bool(o["detected"][0]) and int(o["n_init"][0]) == n0)
    print(f"NPRACH: {det}/4 preambles detected")
    ok &= det == 4

    print("NB-IoT test OK" if ok else "NB-IoT test NOK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
