#!/usr/bin/env python3
"""Write the simulators' records from a run on one GPU.

    python -m openairinterface5g_tpu_torch.tools.sim_records
        [--out-dir DIR] [--only conformance|curves]

* ``CONFORMANCE_torch.txt``: the 33-point nr_ulsim conformance matrix
  through ``sim/autotest.py --conformance --isolate`` (one process per
  point, ``--backend kernel``): per point PASS or FAIL, the first SNR line,
  the SNR of the pass and the wall seconds, under a header with the card's
  name and power limit.
* ``BLER_CURVES_torch.json``: ulsim ``-t 0`` sweeps of the two ulsim
  configurations of ``BLER_CURVES_r5.json`` (the JAX package's curves,
  64 trials a point), 256 trials a point at its SNRs, with
  ``--backend reference`` and ``kernel``.  Beside each point: the JAX
  value, the 99 % Clopper-Pearson interval of the JAX round-0 BLER,
  whether the port's round-0 BLER lies inside it, and whether it lies
  above it (worse than the JAX package's).  Under ``ml_vs_mmse_2layer``:
  the round-0 BLER of the linear MMSE and the joint ML receiver at one SNR
  of ``BLER_ML_r5.json`` (24 PRB, MCS 9, 2 layers, 2x2, TDL-A 100 ns, 12
  iterations as ``tests/test_ml_receiver.py`` runs it), 256 trials each,
  with ``--backend reference`` (flooding, as the JAX values) and
  ``kernel``, beside the JAX values there.  ``--only ml`` adds this pair to the
  file already in ``--out-dir`` (or the repository's).

Both files go to ``--out-dir`` (default: the current directory, the
repository's root when run from there).  Without CUDA it raises: the
records are the card's.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import json
import math
import subprocess
import time
from pathlib import Path

from ..sim import autotest, device_name, resolve_device, ulsim

ROOT = Path(__file__).resolve().parents[2]
TRIALS = 256
CP_LEVEL = 0.99
# (key, JAX curve in BLER_CURVES_r5.json, autotest case whose argv it ran)
CURVES = (
    ("ulsim_mcs9_106_awgn", "ulsim_mcs9_106_awgn_ref_s5", "ulsim-misc1-mcs9-106"),
    ("ulsim_GFR1A513_mcs20_106_2rx_tdla", "ulsim_GFR1A513_mcs20_106_2rx_tdla_ref_12p4",
     "ulsim-conformance-GFR1A513"),
)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _binom_cdf(k: int, n: int, p: float) -> float:
    return sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i) for i in range(k + 1))


def clopper_pearson(k: int, n: int, level: float = CP_LEVEL) -> tuple[float, float]:
    """Exact two-sided interval for a binomial proportion of k in n."""
    a = (1 - level) / 2

    def solve(f, target):       # f increasing in p on [0, 1]
        lo, hi = 0.0, 1.0
        for _ in range(60):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if f(mid) < target else (lo, mid)
        return (lo + hi) / 2

    lower = 0.0 if k == 0 else solve(lambda p: 1 - _binom_cdf(k - 1, n, p), a)
    upper = 1.0 if k == n else solve(lambda p: -_binom_cdf(k, n, p), -a)
    return lower, upper


def curve_argv(case_argv: list[str], snrs: list[float]) -> list[str]:
    """The case's ulsim flags as a -t 0 sweep of TRIALS trials over snrs."""
    argv, skip = [], False
    for a in case_argv:
        if skip:
            skip = False
        elif a in ("-s", "-S", "-n", "-t"):
            skip = True
        else:
            argv.append(a)
    step = snrs[1] - snrs[0]
    return argv + ["-s", str(snrs[0]), "-S", str(snrs[-1]), "--snr-step", str(step),
                   "-n", str(TRIALS), "-t", "0"]


def curves(dev) -> dict:
    jax_curves = json.loads((ROOT / "BLER_CURVES_r5.json").read_text())
    cases = {c[0]: c[2] for c in autotest.CASES}
    out = {}
    for key, jax_key, case in CURVES:
        ref = jax_curves[jax_key]
        snrs = [pt["snr_db"] for pt in ref]
        argv = curve_argv(cases[case], snrs)
        entry = {"argv": argv, "jax_key": jax_key, "jax": ref}
        for backend in ("reference", "kernel"):
            args = ulsim.parse_args([*argv, "--backend", backend])
            t0 = time.time()
            res, _ = ulsim.sweep(args, ulsim.config(args), dev)
            for pt, jpt in zip(res, ref):
                k = round(jpt["bler_round0"] * jpt["trials"])
                lo, hi = clopper_pearson(k, jpt["trials"])
                pt["jax_bler_round0"] = jpt["bler_round0"]
                pt["jax_round0_cp99"] = [lo, hi]
                pt["round0_within_cp99"] = lo <= pt["bler_round0"] <= hi
                pt["round0_above_cp99"] = pt["bler_round0"] > hi
            entry[backend] = res
            print(f"{key} {backend}: {time.time() - t0:.1f} s; round-0 BLER within the JAX "
                  f"99 % interval at {sum(p['round0_within_cp99'] for p in res)}/{len(res)} SNRs, "
                  f"above it at {sum(p['round0_above_cp99'] for p in res)}")
        out[key] = entry
    return out


ML_SNR_DB = 8.0
ML_ARGV = ["-m", "9", "-R", "24", "-W", "2", "-y", "2", "-g", "TDLA", "--delay-spread", "100",
           "-I", "12", "-s", str(ML_SNR_DB), "-S", str(ML_SNR_DB), "-n", str(TRIALS), "-t", "0"]


def ml_pair(dev) -> dict:
    """Round-0 BLER of the MMSE and the ML receiver at ML_SNR_DB with each
    decoder, the same seed (so the same TBs and channel draws), beside
    BLER_ML_r5.json and the 99 % Clopper-Pearson interval of its values."""
    jax_pt = next(pt for pt in json.loads((ROOT / "BLER_ML_r5.json").read_text())["curve"]
                  if pt["snr_db"] == ML_SNR_DB)
    out = {"argv": ML_ARGV, "jax": jax_pt}
    for receiver, key in (("linear", "bler_mmse"), ("ml", "bler_ml")):
        out[f"jax_{receiver}_cp99"] = clopper_pearson(round(jax_pt[key] * jax_pt["n_trials"]),
                                                      jax_pt["n_trials"])
        for backend in ("reference", "kernel"):
            args = ulsim.parse_args([*ML_ARGV, "--receiver", receiver, "--backend", backend])
            t0 = time.time()
            res, _ = ulsim.sweep(args, ulsim.config(args), dev)
            out[f"{receiver}_{backend}"] = res[0]
            print(f"ml_vs_mmse_2layer {receiver} {backend}: round-0 BLER "
                  f"{res[0]['bler_round0']:.6f} at {ML_SNR_DB} dB ({time.time() - t0:.1f} s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--only", choices=["conformance", "curves", "ml"], default=None)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = card()
    stamp = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d %H:%M UTC")
    print(smi)
    if args.only in (None, "conformance"):
        cmd = "python -m openairinterface5g_tpu_torch.sim.autotest --conformance --isolate"
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = autotest.main(["--conformance", "--isolate", "--device", "cuda"])
        text = buf.getvalue()
        header = (f"# nr_ulsim conformance matrix through the PyTorch port on {smi}\n"
                  f"# {cmd} (tools/sim_records.py), {stamp}, {time.time() - t0:.0f} s, "
                  f"exit {rc}\n"
                  f"# per point: verdict (wall s), the first SNR line, the SNR of the pass\n")
        (out_dir / "CONFORMANCE_torch.txt").write_text(header + text)
        print(text)
    if args.only in (None, "curves", "ml"):
        path = out_dir / "BLER_CURVES_torch.json"
        if args.only == "ml":
            data = json.loads((path if path.exists() else ROOT / path.name).read_text())
        else:
            data = {"card": smi, "device": device_name(dev), "generated": stamp,
                    "tool": "openairinterface5g_tpu_torch/tools/sim_records.py",
                    "trials": TRIALS, "curves": curves(dev)}
        data["ml_vs_mmse_2layer"] = {"card": smi, "generated": stamp, **ml_pair(dev)}
        path.write_text(json.dumps(data, indent=1) + "\n")


if __name__ == "__main__":
    main()
