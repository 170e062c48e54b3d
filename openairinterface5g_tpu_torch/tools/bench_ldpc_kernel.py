#!/usr/bin/env python3
"""Time the LDPC decoder's variants (K1 and K2) on one GPU.

    python -m openairinterface5g_tpu_torch.tools.bench_ldpc_kernel --variants f32,bf16,int8

Port of tools/bench_ldpc_kernel.py with its flags and defaults: BG1, Z=384,
64 code blocks, 6 iterations, Es/N0 4 dB, 6 reps.  The code blocks are
random, encoded, sent as BPSK over AWGN and clipped to +-24; each rep
decodes its own noise draw, under the layered schedule as in the original.
A variant is a message type, ``f32``, ``bf16`` (K2) or ``int8``, with
optional ``:``-separated parts: ``sbN`` is accepted and has no effect on
the card; ``noroll`` (a TPU timing mode that decodes garbage) is not
carried into the port and raises.  ``--device`` is the port's own flag.

Each variant's time is the mean over ``--reps`` decodes after one warm-up
decode, by CUDA events; the printed line is the original's:
``<variant> <ms> ms/<B>cb <Mbps> Mbps info ok=<n>/<B>``, the ok count from
the first rep's decode.  ``--device cpu`` runs the plain versions, timed
by the host clock (not a device time).  Without CUDA and without
``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..coding import ldpc
from ..ops import ldpc_decoder

_MSG = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--cbs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--Z", type=int, default=384)
    ap.add_argument("--bg", type=int, default=1)
    ap.add_argument("--variants", default="f32")
    ap.add_argument("--check-every", type=int, default=0)
    ap.add_argument("--snr", type=float, default=4.0,
                    help="Es/N0 dB for realistic convergent LLRs")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain)")
    return ap.parse_args(argv)


def parse_variant(variant: str) -> torch.dtype:
    """The message type of a variant string; raises on what is not ported."""
    parts = variant.split(":")
    if parts[0] not in _MSG:
        raise ValueError(f"variant {variant!r}: message type must be one of {sorted(_MSG)}")
    for p in parts[1:]:
        if p == "noroll":
            raise ValueError("variant part 'noroll' is a TPU timing mode, not carried "
                             "into the port (ROADMAP.md, 'Not carried into the port')")
        if not (p.startswith("sb") and p[2:].isdigit()):
            raise ValueError(f"variant {variant!r}: unknown part {p!r}")
    return _MSG[parts[0]]


def make_llrs(g, B: int, reps: int, snr: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(info (B, K) int8, llrs (reps, B, cols*Z) f32) from numpy seed 0."""
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, g.K)).astype(np.int8)
    cw = ldpc.encode(g, torch.as_tensor(info)).numpy()
    x = 1.0 - 2.0 * cw.astype(np.float32)
    sigma2 = 10 ** (-snr / 10)
    llrs = [np.clip(2.0 * (x + rng.normal(0, np.sqrt(sigma2), cw.shape).astype(np.float32))
                    / sigma2, -24, 24) for _ in range(reps)]
    return (torch.as_tensor(info, device=device),
            torch.as_tensor(np.stack(llrs).astype(np.float32), device=device))


def _mean_ms(fn, n: int, cuda: bool) -> float:
    fn(0)                                            # warm-up
    if not cuda:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(n):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def run(args) -> list[dict]:
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a GPU, or pass --device cpu "
                           "for the plain versions")
    g = ldpc.build_graph(args.bg, args.Z)
    B, R = args.cbs, args.reps
    info, llrs = make_llrs(g, B, R, args.snr, device)
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events" if cuda
             else "cpu, plain versions, host clock")
    print(f"BG{args.bg} Z={args.Z} {B} cbs {args.iters} iters "
          f"check_every={args.check_every} snr={args.snr} dB reps={R} on {where}")
    out = []
    for variant in args.variants.split(","):
        msg_dtype = parse_variant(variant)

        def dec(i):
            return ldpc_decoder.decode(g, llrs[i % R], args.iters, msg_dtype=msg_dtype,
                                       check_every=args.check_every)

        per_ms = _mean_ms(dec, R, cuda)
        bits, ok = dec(0)
        n_ok = int(ok.sum())
        mbps = B * g.K / (per_ms * 1e-3) / 1e6
        print(f"{variant:14s} {per_ms:8.2f} ms/{B}cb  {mbps:8.1f} Mbps info   ok={n_ok}/{B}")
        out.append({"variant": variant, "ms": per_ms, "mbps": mbps, "ok": n_ok,
                    "bits_equal_sent": bool(torch.equal(bits, info))})
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
