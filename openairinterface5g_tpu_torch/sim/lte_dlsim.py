"""LTE PDSCH BLER / throughput simulator (the reference's dlsim,
openair1/SIMULATION/LTE_PHY/dlsim.c).

Port of openairinterface5g_tpu/sim/lte_dlsim.py, with its flags, lines and
pass string ("LTE PDSCH test OK"): eNB TX -> channel -> UE RX per batch of
trials, HARQ rounds with stream-LLR combining, on the run's device (the
card unless --device cpu).  As the JAX simulator, the run passes when
every SNR of the sweep reaches the effective-throughput gate.  lte_ulsim
runs the same sweep on the PUSCH (``uplink=True``).

Usage: python -m openairinterface5g_tpu_torch.sim.lte_dlsim -m 28 -R 100 -s 30 -n 64
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..lte import pdsch as lte_pdsch
from ..lte import pusch as lte_pusch
from . import device_name, resolve_device
from .channel import ChannelModel, _complex_normal, convolve_taps, draw_taps

HARQ_RV_SEQ = (0, 1, 2, 3)      # LTE rv order (36.321 canonical cycling)

# LTE TDD uplink-downlink configurations (TS 36.211 Table 4.2-2), a copy of
# the JAX package's runtime/tdd.py table
LTE_TDD_CONFIGS = {
    0: "DSUUUDSUUU",
    1: "DSUUDDSUUD",
    2: "DSUDDDSUDD",
    3: "DSUUUDDDDD",
    4: "DSUUDDDDDD",
    5: "DSUDDDDDDD",
    6: "DSUUUDSUUD",
}


def lte_tdd_counts(config: int) -> tuple:
    """(n_dl, n_special, n_ul) subframes per 10 ms frame."""
    p = LTE_TDD_CONFIGS[config]
    return p.count("D"), p.count("S"), p.count("U")


def _chain(uplink: bool):
    if uplink:
        return lte_pusch.pusch_tx, lte_pusch.pusch_rx
    return lte_pdsch.pdsch_tx, lte_pdsch.pdsch_rx


def trial(cfg, tb: torch.Tensor, snr_db: float, taps: list, noise: list, n_iters: int = 6,
          uplink: bool = False) -> torch.Tensor:
    """One batch of trials at snr_db with its draws: per HARQ round, taps[r]
    (B, n_rx, 1, L) the channel's FIR and noise[r] (B, n_rx, samples) unit
    complex normal draws (unit variance per component).  Returns ok per round
    (rounds, B) bool."""
    tx_fn, rx_fn = _chain(uplink)
    oks, acc = [], None
    for r in range(len(taps)):
        rv = HARQ_RV_SEQ[r % 4]
        tx, _ = tx_fn(cfg, tb, rv=rv)
        sig = torch.mean(torch.sum(tx.abs() ** 2, dim=-2))
        sigma2 = sig * (cfg.fp.fft_size / cfg.fp.n_sc) * 10 ** (-snr_db / 10)
        rx = convolve_taps(taps[r], tx) + torch.sqrt(sigma2 / 2) * noise[r]
        out = rx_fn(cfg, rx, rv=rv, n_iters=n_iters, acc_streams=acc)
        acc = out["streams"]
        oks.append(out["tb_ok"])
    return torch.stack(oks)


def build_step(cfg, max_rounds: int, n_iters: int, channel_name: str,
               delay_spread_ns: float = 30.0, uplink: bool = False):
    """step(gen, tb, snr_db) -> (rounds, B) ok: trial with draws from gen on
    tb's device, a new channel realization and noise each round."""
    model = ChannelModel(channel_name, 1, cfg.n_rx, cfg.fp.sample_rate,
                         delay_spread_ns=delay_spread_ns)
    n_samp = cfg.fp.samples_per_subframe

    def step(gen: torch.Generator, tb: torch.Tensor, snr_db: float) -> torch.Tensor:
        B = tb.shape[0]
        taps, noise = [], []
        for _ in range(max_rounds):
            taps.append(draw_taps(model, gen, (B,)))
            noise.append(_complex_normal(gen, (B, cfg.n_rx, n_samp)))
        return trial(cfg, tb, snr_db, taps, noise, n_iters, uplink)

    return step


def run_sweep(cfg, snrs, n_trials: int, batch: int, max_rounds: int = 1, n_iters: int = 6,
              channel: str = "AWGN", eff_tp_check: float = 70.0, seed: int = 42,
              verbose: bool = True, delay_spread_ns: float = 30.0, uplink: bool = False,
              duty: float = 1.0, device: str | torch.device = "cuda"):
    """Every SNR of `snrs`; returns (per-SNR results, passed): passed when each
    SNR's effective throughput reaches eff_tp_check."""
    step = build_step(cfg, max_rounds, n_iters, channel, delay_spread_ns, uplink=uplink)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    rng = np.random.default_rng(seed)
    results, all_pass = [], True
    for snr_db in snrs:
        n_done = ok_any = rounds_used = 0
        t0 = time.time()
        while n_done < n_trials:
            B = min(batch, n_trials - n_done)
            tb = torch.as_tensor(rng.integers(0, 2, (batch, cfg.tbs)).astype(np.int8), device=dev)
            gen.manual_seed(int(rng.integers(1 << 30)))
            oks = step(gen, tb, float(snr_db)).cpu().numpy()[:, :B]
            any_ok = oks.any(axis=0)
            ok_any += int(any_ok.sum())
            rounds_used += int(np.where(any_ok, oks.argmax(axis=0) + 1, max_rounds).sum())
            n_done += B
        dt = time.time() - t0
        bler = 1.0 - ok_any / n_done
        avg_rounds = rounds_used / n_done
        eff_tp = 100.0 * (ok_any / n_done) / avg_rounds
        # per 1 ms subframe, scaled by the TDD duty factor (1.0 = FDD)
        mbps = cfg.tbs * (ok_any / n_done) / avg_rounds / 1e3 * duty
        results.append({"snr_db": float(snr_db), "bler": bler, "avg_rounds": avg_rounds,
                        "eff_throughput_pct": eff_tp, "mbps": mbps, "trials": n_done,
                        "wall_s": dt})
        if verbose:
            print(f"SNR {snr_db:6.2f} dB | BLER {bler:.6f} | avg rounds "
                  f"{avg_rounds:.2f} | {mbps:.2f} Mb/s | eff TP {eff_tp:.2f}% "
                  f"| {n_done} trials in {dt:.1f}s")
        if eff_tp < eff_tp_check:
            all_pass = False
    return results, all_pass


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="LTE PDSCH simulator (dlsim analog)")
    ap.add_argument("-m", "--mcs", type=int, default=28)
    ap.add_argument("-R", "--n-rb", type=int, default=50)
    ap.add_argument("-s", "--snr0", type=float, default=30.0)
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
    ap.add_argument("-d", "--tdd-config", type=int, default=None, choices=range(7),
                    help="LTE TDD uplink-downlink configuration (36.211 Table 4.2-2); "
                         "throughput reflects the DL duty (D subframes + DwPTS at "
                         "11/14 symbols)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = lte_pdsch.LtePdschConfig(n_rb=args.n_rb, n_prb=args.n_rb, mcs=args.mcs,
                                   n_rx=args.n_rx)
    duty = 1.0
    if args.tdd_config is not None:
        n_d, n_s, _ = lte_tdd_counts(args.tdd_config)
        duty = (n_d + n_s * 11.0 / 14.0) / 10.0
    print(f"LTE PDSCH sim: {args.n_rb} PRB MCS {args.mcs} (Qm={cfg.qm}) "
          f"TBS {cfg.tbs} C={cfg.seg().C} channel={args.channel}"
          + (f" TDD cfg {args.tdd_config} (DL duty {duty:.2f})"
             if args.tdd_config is not None else " FDD"))
    print(f"device: {device_name(dev)}")
    snr1 = args.snr1 if args.snr1 is not None else args.snr0
    snrs = np.arange(args.snr0, snr1 + 1e-9, args.snr_step)
    batch = args.batch or max(1, min(32, args.n_trials))
    results, ok = run_sweep(cfg, snrs, args.n_trials, batch, max_rounds=args.max_rounds,
                            n_iters=args.n_iters, channel=args.channel,
                            eff_tp_check=args.eff_tp_check, duty=duty, device=dev)
    if args.json:
        print(json.dumps(results))
    print("LTE PDSCH test OK" if ok else "LTE PDSCH test NOK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
