"""nr-softmodem-style continuous slot loop (phytest / noS1 mode analog).

Port of openairinterface5g_tpu/runtime/softmodem.py.  Mirrors the
reference's gNB real-time loop (executables/nr-softmodem.c -> ru_thread ->
L1 rx/tx threads, SURVEY.md §3.1) at simulation level: a MAC-lite
scheduler drives per-slot UL processing over a stream of slots, UEs
transmit through the channel simulator, CRC indications feed HARQ back,
with the executor's dispatch depth on a CUDA stream standing in for the
reference thread pipeline, and per-slot timing collected like
rt_L1_profiling.

The TBs come from np.random.default_rng(0) in the JAX loop's order, so they
equal its TBs; each UL slot's AWGN comes from a torch.Generator on the
run's device seeded with the slot index (the JAX loop's
jax.random.PRNGKey(slot) stream cannot be reproduced).

Usage: python -m openairinterface5g_tpu_torch.runtime.softmodem -n 20 -u 2
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..models.gnb import SlotDlConfig, gnb_dl_slot, gnb_ul_slot
from ..models.pdsch import PdschConfig
from ..models.pusch import PuschConfig, pusch_tx
from ..sim import resolve_device
from ..sim.channel import add_noise
from .executor import SlotExecutor
from .scheduler import PhytestScheduler
from .tdd import TddConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="continuous multi-slot gNB loop")
    ap.add_argument("-n", "--n-slots", type=int, default=20)
    ap.add_argument("-u", "--n-ues", type=int, default=2)
    ap.add_argument("-m", "--mcs", type=int, default=9)
    ap.add_argument("-P", "--prb-per-ue", type=int, default=24)
    ap.add_argument("-s", "--snr-db", type=float, default=14.0)
    ap.add_argument("-I", "--n-iters", type=int, default=10)
    ap.add_argument("--backend", type=str, default="reference",
                    choices=["reference", "kernel"])
    ap.add_argument("--tdd", type=str, default=None,
                    help="TDD pattern 'dlSlots,dlSyms,ulSlots,ulSyms"
                         "[,period_ms]' (tdd-UL-DL-ConfigCommon analog); "
                         "default: FDD (all slots UL in this UL-RX loop)")
    ap.add_argument("--depth", type=int, default=2,
                    help="slots in flight before the host waits for the oldest")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def ue_configs(args) -> list[PuschConfig]:
    """The UEs' PUSCH allocations: disjoint PRB ranges of one BWP."""
    bwp = args.prb_per_ue * args.n_ues
    return [PuschConfig(mu=1, n_prb=args.prb_per_ue, prb_start=i * args.prb_per_ue,
                        n_bwp_prb=bwp, mcs=args.mcs, rnti=0x1000 + i,
                        decoder_backend=args.backend)
            for i in range(args.n_ues)]


def run(args, log=print) -> dict:
    """The loop; returns kinds, UL TB ok flags per slot, wall seconds, the
    executor and the scheduler."""
    dev = resolve_device(args.device)
    ues = ue_configs(args)
    bwp = ues[0].bwp_prbs
    sched = PhytestScheduler(ues)
    tbs = ues[0].tbs
    tdd = TddConfig.from_string(args.tdd) if args.tdd else None
    log(f"softmodem loop: {args.n_ues} UEs x {args.prb_per_ue} PRB MCS {args.mcs} "
        f"TBS {tbs} @ {args.snr_db} dB, backend={args.backend}"
        + (f", TDD pattern {tdd.pattern()}" if tdd else ", FDD"))

    def ul_slot_fn(seed, tbs_bits, snr_db):
        # all UEs transmit (superimposed on the shared band) + AWGN
        rx = sum(pusch_tx(ue, tbs_bits[i][None])[0] for i, ue in enumerate(ues))
        sig = torch.mean(torch.sum(torch.abs(rx) ** 2, dim=-2)) / args.n_ues
        sigma2 = sig * (ues[0].fp.fft_size / ues[0].fp.n_sc) * 10 ** (-snr_db / 10)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        rx = add_noise(gen, rx, sigma2)
        ul, _ = sched.schedule_slot(0)
        out = gnb_ul_slot(ul, rx, n_iters=args.n_iters)
        return [c["tb_ok"][0] for c in out["crc_indication"]]

    # DL TX slot: compose every UE's PDSCH on one grid + OFDM (TDD D slots;
    # phy_procedures_gNB_TX analog: the DL allocations mirror the UL ones)
    dl_cfgs = tuple(
        PdschConfig(mu=1, n_prb=args.prb_per_ue, prb_start=i * args.prb_per_ue,
                    n_bwp_prb=bwp, mcs=args.mcs, rnti=0x1000 + i)
        for i in range(args.n_ues))
    dl_tbs = dl_cfgs[0].tbs
    dl = SlotDlConfig(mu=1, n_bwp_prb=bwp, pdsch=dl_cfgs)

    def dl_slot_fn(tbs_bits):
        tx, _ = gnb_dl_slot(dl, [b[None] for b in tbs_bits])
        return torch.sum(torch.abs(tx))     # materialize the waveform

    rng = np.random.default_rng(0)
    slot_dur = 0.001 / (1 << 1)             # mu=1: 500 us
    kinds = [(tdd.slot_type(s) if tdd else "U") for s in range(args.n_slots)]

    def dispatch(i, kind, *a):
        return ul_slot_fn(*a) if kind == "U" else \
            (dl_slot_fn(*a) if kind == "D" else torch.zeros(()))

    def bits(n):
        return torch.as_tensor(rng.integers(0, 2, (n,)).astype(np.int8), device=dev)

    ex = SlotExecutor(dispatch, depth=args.depth, slot_duration_s=slot_dur, device=dev)
    inputs = []
    for s, kind in enumerate(kinds):
        if kind == "U":
            inputs.append((kind, s, [bits(tbs) for _ in range(args.n_ues)], args.snr_db))
        elif kind == "D":
            inputs.append((kind, [bits(dl_tbs) for _ in range(args.n_ues)]))
        else:
            inputs.append((kind,))

    t0 = time.time()
    results = ex.run(inputs)
    wall = time.time() - t0
    ul_ok = [[bool(ok) for ok in oks] if kind == "U" else None
             for kind, oks in zip(kinds, results)]
    return {"kinds": kinds, "ul_ok": ul_ok, "wall": wall, "executor": ex, "sched": sched,
            "tbs": tbs, "dl_tbs": dl_tbs}


def main(argv=None):
    args = parse_args(argv)
    r = run(args)
    kinds, ex, sched, wall = r["kinds"], r["executor"], r["sched"], r["wall"]
    n_ok = 0
    n_ul = kinds.count("U")
    n_dl = kinds.count("D")
    dl_bits = n_dl * args.n_ues * r["dl_tbs"]
    for oks in r["ul_ok"]:
        if oks is None:
            continue
        for i, ok_b in enumerate(oks):
            sched.handle_crc_indication(i, ok_b)
            n_ok += ok_b
    total = n_ul * args.n_ues
    thr = n_ok * r["tbs"] / wall / 1e6
    print(ex.report())
    print(f"slots/s: {args.n_slots / wall:.1f}  "
          f"[{n_dl} DL / {kinds.count('S')} S / {n_ul} UL]  "
          f"UL TB ok: {n_ok}/{total}  UL MAC throughput: {thr:.1f} Mb/s  "
          f"DL TX: {dl_bits / wall / 1e6:.1f} Mb/s")
    for st in sched.stats():
        print(f"  rnti 0x{st['rnti']:04x}: acked {st['acked']} nacked {st['nacked']}")
    print("softmodem loop OK" if n_ok == total else "softmodem loop DEGRADED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
