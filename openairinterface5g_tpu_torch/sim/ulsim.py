"""nr_ulsim equivalent: PUSCH BLER/throughput simulator.

Port of openairinterface5g_tpu/sim/ulsim.py, with its flags, output lines
and pass string ("PUSCH test OK"): the reference simulator's loop
structure and pass criteria (ulsim.c:915 SNR loop, :1498 result prints).
Each batch of trials at one SNR runs eagerly on the run's device, trials
as the batch dimension, HARQ rounds as a loop with LLR-buffer combining.
On CUDA, ``pusch_rx`` runs K3 where ``ops/pusch_frontend.supported``
admits the configuration and the unfused chain otherwise (PTRS, data on
the DMRS symbols, the ML receiver); ``--backend kernel`` decodes with K1,
``reference`` with the flooding decoder of ``coding/ldpc.py``.  With a
``csirs_cfg`` (dlsim ``--csirs``) each slot also carries a CSI-RS inside
the allocation, which the configuration's ``rm_res`` rate-matches around.

Usage:
  python -m openairinterface5g_tpu_torch.sim.ulsim -m 9 -R 106 -s 0 -S 10 -n 100
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..data.tables import pusch_dmrs_symbols
from ..models import pusch
from ..models.csirs import csirs_tx_grid
from ..phy.ofdm import map_to_grid, ofdm_modulate
from . import device_name, resolve_device
from .channel import ChannelModel, add_noise, apply_cfo, apply_channel, doppler_phasor

HARQ_RV_SEQ = (0, 2, 3, 1)  # nr_rv_round_map (gNB_scheduler.c:56)


def noise_variance(cfg, tx: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Noise variance per sample for `snr_db` (ulsim.c:1190): relative to
    one TX antenna's per-sample power (the power of all layers over
    n_layers), scaled by fft_size / n_sc, so the SNR is per occupied RE."""
    sig = torch.mean(torch.sum(tx.abs() ** 2, dim=-2)) / cfg.n_layers
    return sig * (cfg.fp.fft_size / cfg.fp.n_sc) * 10 ** (-snr_db / 10)


def build_step(cfg, max_rounds: int, n_iters: int, channel_name: str,
               delay_spread_ns: float = 30.0, time_shift: int = 0,
               doppler_hz: float = 0.0, cfo_hz: float = 0.0, csirs_cfg=None):
    model = ChannelModel(channel_name, cfg.n_layers, cfg.n_rx,
                         cfg.fp.sample_rate, delay_spread_ns=delay_spread_ns,
                         max_doppler_hz=doppler_hz)

    def step(gen: torch.Generator, tb: torch.Tensor, snr_db: float) -> torch.Tensor:
        """One batch of trials at one SNR, drawn from `gen` on tb's device.
        Returns ok_round (rounds, B) bool."""
        oks = []
        harq = None
        for rv in HARQ_RV_SEQ[:max_rounds]:
            if csirs_cfg is not None:
                # the CSI-RS inside the allocation, on layer 0's grid
                g, _ = pusch.pusch_tx_grid(cfg, tb, rv=rv)
                g[:, 0, csirs_cfg.symbol] += csirs_tx_grid(csirs_cfg, tb.shape[0],
                                                           cfg.fp.n_sc, tb.device)
                tx = ofdm_modulate(cfg.fp, map_to_grid(cfg.fp, g), cfg.slot)
            else:
                tx, _ = pusch.pusch_tx(cfg, tb, rv=rv)
            sigma2 = noise_variance(cfg, tx, snr_db)
            rx, _ = apply_channel(model, gen, tx)
            if doppler_hz > 0.0:
                rx = rx * doppler_phasor(model, gen, rx.shape[-1])
            if cfo_hz != 0.0:
                rx = apply_cfo(rx, cfg.fp.sample_rate, cfo_hz)
            if time_shift:
                # receive-window offset (ulsim.c -d): the slot arrives
                # `time_shift` samples late in the RX buffer
                rx = torch.cat([rx.new_zeros((*rx.shape[:-1], time_shift)),
                                rx[..., : rx.shape[-1] - time_shift]], dim=-1)
            rx = add_noise(gen, rx, sigma2)
            out = pusch.pusch_rx(cfg, rx, rv=rv, n_iters=n_iters, harq_buffers=harq)
            harq = out["harq_buffers"]
            oks.append(out["tb_ok"])
        return torch.stack(oks)

    return step


def run_sweep(cfg, snrs, n_trials: int, batch: int, max_rounds: int = 1,
              n_iters: int = 20, channel: str = "AWGN", eff_tp_check: float = 70.0,
              seed: int = 42, verbose: bool = True, delay_spread_ns: float = 30.0,
              time_shift: int = 0, doppler_hz: float = 0.0, cfo_hz: float = 0.0,
              csirs_cfg=None, device: str | torch.device = "cuda"):
    """Sweep `snrs` until the effective throughput reaches `eff_tp_check`
    (all of them when it is <= 0); returns (per-SNR results, passed)."""
    step = build_step(cfg, max_rounds, n_iters, channel, delay_spread_ns,
                      time_shift=time_shift, doppler_hz=doppler_hz, cfo_hz=cfo_hz,
                      csirs_cfg=csirs_cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    rng = np.random.default_rng(seed)
    results = []
    passed = False
    for snr_db in snrs:
        n_done = 0
        ok_first = 0          # round-0 successes
        ok_any = 0
        rounds_used = 0
        t0 = time.time()
        while n_done < n_trials:
            B = min(batch, n_trials - n_done)
            tb = torch.as_tensor(rng.integers(0, 2, size=(batch, cfg.tbs)).astype(np.int8),
                                 device=dev)
            gen.manual_seed(int(rng.integers(1 << 30)))
            oks = step(gen, tb, float(snr_db)).cpu().numpy()[:, :B]
            ok_first += int(oks[0].sum())
            any_ok = oks.any(axis=0)
            ok_any += int(any_ok.sum())
            first_round = np.where(any_ok, oks.argmax(axis=0) + 1, max_rounds)
            rounds_used += int(first_round.sum())
            n_done += B
        dt = time.time() - t0
        bler = 1.0 - ok_any / n_done
        bler_r0 = 1.0 - ok_first / n_done
        avg_rounds = rounds_used / n_done
        eff_rate = cfg.tbs * (ok_any / n_done) / avg_rounds
        eff_tp = 100.0 * (ok_any / n_done) / avg_rounds
        results.append({
            "snr_db": float(snr_db), "bler": bler, "bler_round0": bler_r0,
            "avg_rounds": avg_rounds, "eff_rate_bits_per_slot": eff_rate,
            "eff_throughput_pct": eff_tp, "trials": n_done, "wall_s": dt,
        })
        if verbose:
            print(f"SNR {snr_db:6.2f} dB | BLER {bler:.6f} (round0 {bler_r0:.6f}) | "
                  f"avg rounds {avg_rounds:.2f} | eff rate {eff_rate:.1f} bits/slot | "
                  f"eff TP {eff_tp:.2f}% | {n_done} trials in {dt:.1f}s")
        if eff_tp_check > 0 and eff_tp >= eff_tp_check:
            # reference semantics (ulsim.c:1572): the sweep passes at the
            # FIRST SNR meeting the effective-throughput gate
            passed = True
            break
    if eff_tp_check <= 0:
        passed = True            # -t 0: curve mode, sweep everything
    return results, passed


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="PUSCH BLER simulator (nr_ulsim analog)")
    ap.add_argument("-m", "--mcs", type=int, default=9)
    ap.add_argument("-R", "--n-prb", type=int, default=106)
    ap.add_argument("-q", "--mcs-table", type=int, default=1)
    ap.add_argument("-s", "--snr0", type=float, default=0.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("-u", "--mu", type=int, default=1)
    ap.add_argument("-W", "--n-layers", type=int, default=1)
    ap.add_argument("-y", "--n-rx", type=int, default=1)
    ap.add_argument("-g", "--channel", type=str, default="AWGN",
                    choices=["AWGN", "TDLA", "TDLB", "TDLC", "EPA", "EVA", "ETU"])
    ap.add_argument("-M", "--max-rounds", type=int, default=1)
    ap.add_argument("--delay-spread", type=float, default=30.0, help="TDL delay spread (ns)")
    ap.add_argument("-D", "--dmrs-add-pos", type=int, default=None, choices=[0, 1],
                    help="legacy alias for -U 0,<pos>,1,2")
    ap.add_argument("-U", "--dmrs", type=str, default=None,
                    help="DMRS config 'mappingType{0=A,1=B},addPos{0-3},"
                         "configType{1},cdmGroupsNoData{1,2}' (ulsim.c -U)")
    ap.add_argument("-T", "--ptrs", type=str, default=None,
                    help="PTRS 'L_index{0,1,2},K{2,4}': L_PTRS = 1<<L_index "
                         "(ulsim.c -T)")
    ap.add_argument("-a", "--start-symbol", type=int, default=0)
    ap.add_argument("-b", "--n-symbols", type=int, default=14)
    ap.add_argument("-d", "--time-shift", type=int, default=0,
                    help="delay the slot by N samples in the RX window")
    ap.add_argument("--doppler", type=float, default=0.0,
                    help="max Doppler (Hz), TS 38.104 G.3-1 HST trajectory")
    ap.add_argument("--cfo", type=float, default=0.0,
                    help="carrier frequency offset (Hz) applied at RX")
    ap.add_argument("--chest-window", type=int, default=8)
    ap.add_argument("-I", "--n-iters", type=int, default=20)
    ap.add_argument("-t", "--eff-tp-check", type=float, default=70.0)
    ap.add_argument("--backend", type=str, default="reference", choices=["reference", "kernel"],
                    help="LDPC decoder: flooding min-sum in PyTorch, or K1")
    ap.add_argument("--receiver", type=str, default="linear",
                    choices=["linear", "ml"],
                    help="2-layer receiver: linear MMSE or joint max-log "
                         "ML (nr_ulsch_qpsk_qpsk analog)")
    ap.add_argument("--json", action="store_true", help="emit JSON results")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain)")
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    """The PuschConfig of parsed ulsim flags (-U's cdmGroupsNoData, -T's
    PTRS, --receiver)."""
    # -U mappingType,addPos,configType,cdmGroupsNoData (ulsim.c:444)
    mapping, add_pos, cdm = "A", 0, 2
    if args.dmrs_add_pos is not None:
        add_pos = args.dmrs_add_pos
    if args.dmrs is not None:
        f = [int(v) for v in args.dmrs.split(",")]
        mapping = "B" if f[0] == 1 else "A"
        add_pos = f[1] if len(f) > 1 else 0
        if len(f) > 2 and f[2] != 1:
            raise ValueError("DMRS config type 2 not supported")
        cdm = f[3] if len(f) > 3 else 2
    dmrs_syms = pusch_dmrs_symbols(mapping, add_pos, args.start_symbol,
                                   args.n_symbols)
    ptrs_kw = {}
    if args.ptrs is not None:
        l_idx, k = [int(v) for v in args.ptrs.split(",")]
        ptrs_kw = dict(ptrs=True, ptrs_l=1 << l_idx, ptrs_k=k)

    cfg = pusch.PuschConfig(mu=args.mu, n_prb=args.n_prb, mcs=args.mcs,
                            mcs_table=args.mcs_table, n_layers=args.n_layers,
                            n_rx=args.n_rx, decoder_backend=args.backend,
                            start_symbol=args.start_symbol, n_symbols=args.n_symbols,
                            dmrs_symbols=dmrs_syms, cdm_groups_no_data=cdm,
                            chest_window=args.chest_window,
                            receiver=args.receiver, **ptrs_kw)
    return cfg


def sweep(args: argparse.Namespace, cfg, dev: torch.device, verbose: bool = True):
    """run_sweep as parsed ulsim flags ask for it, with `cfg` from config(args):
    (per-SNR results, passed)."""
    # reference default sweep window: snr1 = snr0 + 10 (ulsim.c:538)
    snr1 = args.snr1 if args.snr1 is not None else args.snr0 + 10.0
    snrs = np.arange(args.snr0, snr1 + 1e-9, args.snr_step)
    batch = args.batch or max(1, min(64, args.n_trials))
    return run_sweep(cfg, snrs, args.n_trials, batch,
                     max_rounds=args.max_rounds, n_iters=args.n_iters,
                     channel=args.channel, eff_tp_check=args.eff_tp_check,
                     verbose=verbose, delay_spread_ns=args.delay_spread,
                     time_shift=args.time_shift,
                     doppler_hz=args.doppler, cfo_hz=args.cfo, device=dev)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config(args)
    p, _ = cfg.seg_params()
    print(f"PUSCH sim: {args.n_prb} PRB mu={args.mu} MCS {args.mcs} "
          f"(Qm={cfg.qm_rate[0]} R={cfg.qm_rate[1]:.3f}) {args.n_layers}x{args.n_rx} "
          f"TBS {cfg.tbs} C={p.C} Z={p.Z} G={cfg.G} channel={args.channel} "
          f"dmrs={cfg.dmrs_symbols} cdm={cfg.cdm_groups_no_data}"
          + (f" ptrs=L{cfg.ptrs_l}K{cfg.ptrs_k}" if cfg.ptrs else ""))
    print(f"device: {device_name(dev)}, decoder {args.backend}")
    results, ok = sweep(args, cfg, dev)
    if args.json:
        print(json.dumps(results))
    # same pass string the reference CI greps for (test_case_list.xml)
    print("PUSCH test OK" if ok else "PUSCH test NOK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
