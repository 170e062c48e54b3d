"""nr_ulschsim / nr_dlschsim equivalent: SCH codec-only BLER simulator.

Port of openairinterface5g_tpu/sim/ulschsim.py: the transport-channel
coding chain (TB CRC -> segmentation -> LDPC -> rate matching -> [AWGN on
BPSK] -> recovery -> flooding decode -> CRC) without OFDM or channel
estimation (ulschsim.c / dlschsim.c).  CI points: 106/217/273 PRB MCS
9/15/19 pass at 13/15/20 dB (test_case_list.xml:232-277).

Usage: python -m openairinterface5g_tpu_torch.sim.ulschsim -m 9 -R 106 -s 13 -n 64
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..coding import ldpc, rate_matching, segmentation
from ..coding.crc import crc_attach, crc_ok
from ..models.pusch import PuschConfig
from . import device_name, resolve_device


def main(argv=None, label: str = "ULSCH"):
    ap = argparse.ArgumentParser(description="SCH codec BLER simulator")
    ap.add_argument("-m", "--mcs", type=int, default=9)
    ap.add_argument("-R", "--n-prb", type=int, default=106)
    ap.add_argument("-q", "--mcs-table", type=int, default=1)
    ap.add_argument("-s", "--snr0", type=float, default=13.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=64)
    ap.add_argument("-I", "--n-iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PuschConfig(mu=1, n_prb=args.n_prb, mcs=args.mcs,
                      mcs_table=args.mcs_table)
    p, crc_name = cfg.seg_params()
    qm = cfg.qm_rate[0]
    g = ldpc.build_graph(p.bg, p.Z)
    es = cfg.cb_e_sizes()
    offs = np.concatenate([[0], np.cumsum(es)])
    batch = min(args.n_trials, 16)
    print(f"{label} sim: TBS {cfg.tbs} BG{p.bg} C={p.C} Z={p.Z} G={cfg.G}")
    print(f"device: {device_name(dev)}")
    gen = torch.Generator(device=dev)

    def step(snr_db: float) -> torch.Tensor:
        tb = torch.randint(0, 2, (batch, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
        cbs = segmentation.segment_tb(crc_attach(tb, crc_name), p)
        cw = ldpc.encode(g, cbs.reshape(batch * p.C, p.K)).reshape(batch, p.C, -1)
        e = torch.cat([rate_matching.rate_match_tx(g, cw[:, j], 0, E, p.F)
                       for j, E in enumerate(es)], dim=-1)
        # BPSK over the whole codeword (per-bit SNR; dlschsim convention)
        tx = 1.0 - 2.0 * e.to(torch.float32)
        sigma = 10 ** (-snr_db / 20) * np.sqrt(qm / 2)
        y = tx + sigma * torch.randn(tx.shape, generator=gen, device=dev)
        llr = 2 * y / sigma**2
        fulls = [rate_matching.rate_match_rx(g, llr[:, int(offs[j]): int(offs[j + 1])], 0, p.F)
                 for j in range(p.C)]
        bits, _, _ = ldpc.decode(g, torch.stack(fulls, 1).reshape(batch * p.C, -1),
                                 n_iters=args.n_iters)
        tb_rx = segmentation.desegment_tb(bits.reshape(batch, p.C, -1), p)
        return ~crc_ok(tb_rx, crc_name)

    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    ok_all = True
    for snr in np.arange(args.snr0, snr1 + 1e-9, args.snr_step):
        rng = np.random.default_rng(5)
        n_err = n_done = 0
        t0 = time.time()
        while n_done < args.n_trials:
            gen.manual_seed(int(rng.integers(1 << 30)))
            errs = step(float(snr))
            take = min(batch, args.n_trials - n_done)
            n_err += int(errs[:take].sum())
            n_done += take
        bler = n_err / n_done
        print(f"SNR {snr:.2f} dB: BLER {bler:.6f} ({n_err}/{n_done}) in {time.time()-t0:.1f}s")
        if bler > 0:
            ok_all = False
    print(f"{label} test OK" if ok_all else f"{label} test NOK")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
