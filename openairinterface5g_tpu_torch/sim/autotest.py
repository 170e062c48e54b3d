"""Autotest runner: the reference CI operating points as one command.

Port of openairinterface5g_tpu/sim/autotest.py (run_exec_autotests.bash +
test_case_list.xml): each case runs a simulator CLI and greps its stdout
for the pass string.  The case lists are the JAX package's, with its
``--backend pallas`` as the port's ``kernel``.  A case whose simulator the
port lacks, or that needs a branch the port lacks (the simulator raises
NotImplementedError naming its ROADMAP.md item), is printed as NOT PORTED
with its item and counted apart from pass and fail.  Every ported case
runs on ``--device`` (the card unless asked for the CPU).

For each case the runner prints, beside PASS or FAIL and the wall
seconds, the simulator's first SNR line and the SNR of its last line: the
sweeps stop at the first SNR that passes, so for a PASS that is the SNR
at which it passed.

Usage:
  python -m openairinterface5g_tpu_torch.sim.autotest            # quick set
  python -m openairinterface5g_tpu_torch.sim.autotest --full     # all points
  python -m openairinterface5g_tpu_torch.sim.autotest --conformance --isolate
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import re
import subprocess
import sys
import time
from typing import NamedTuple

from . import resolve_device

CASES = [
    # (id, module, argv, pass_string, quick)
    ("ldpctest-BG1-8448", "ldpctest", ["-l", "8448", "-s", "10", "-n", "64"], "BLER 0.000000", True),
    ("ldpctest-BG1-3872", "ldpctest", ["-l", "3872", "-s", "10", "-n", "64"], "BLER 0.000000", False),
    ("ldpctest-BG2-1024", "ldpctest", ["-l", "1024", "-s", "10", "-n", "64"], "BLER 0.000000", False),
    ("polartest-PBCH", "polartest", ["-q", "-s", "-6", "-n", "64"], "BLER 0.000000", True),
    ("polartest-DCI", "polartest", ["-c", "-k", "40", "-E", "216", "-s", "0", "-n", "64"], "BLER 0.000000", False),
    ("polartest-UCI", "polartest", ["-u", "-k", "16", "-E", "240", "-s", "0", "-n", "64"], "BLER 0.000000", False),
    ("pbchsim-m7dB", "pbchsim", ["-s", "-7", "-n", "64"], "PBCH test OK", True),
    # nr_ulsim.misc at the reference SNRs (test_case_list.xml:372-389)
    ("ulsim-misc1-mcs9-106", "ulsim", ["-m", "9", "-R", "106", "-s", "5", "-n", "100", "-t", "99"], "PUSCH test OK", True),
    ("ulsim-misc2-mcs16-50", "ulsim", ["-m", "16", "-R", "50", "-s", "10", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc3-mcs28-50", "ulsim", ["-m", "28", "-R", "50", "-s", "20", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc4-mcs27-256qam", "ulsim", ["-m", "27", "-q", "2", "-R", "50", "-s", "25", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc5-mcs9-217", "ulsim", ["-m", "9", "-R", "217", "-s", "5", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc6-mcs9-273", "ulsim", ["-m", "9", "-R", "273", "-s", "5", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc7-2dmrs", "ulsim", ["-s", "5", "-n", "100", "-U", "0,1,1,1", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc8-3dmrs-ptrs", "ulsim", ["-s", "5", "-n", "100", "-T", "1,2", "-U", "0,2,1,1", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc9-typeB-ptrs", "ulsim", ["-s", "5", "-n", "100", "-T", "2,2", "-U", "1,2,1,1", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc10-typeB-8sym", "ulsim", ["-s", "5", "-n", "100", "-a", "4", "-b", "8", "-T", "1,2", "-U", "1,3,1,1", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc11-15kHz-25", "ulsim", ["-u", "0", "-m", "0", "-R", "25", "-s", "5", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc12-mcs0-lowsnr", "ulsim", ["-m", "0", "-s", "-0.6", "-n", "100", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-misc13-timeshift8", "ulsim", ["-m", "28", "-R", "106", "-s", "24", "-d", "8", "-n", "100", "-t", "90"], "PUSCH test OK", False),
    ("ulsim-mcs9-sc-fdma", "ulsim", ["-m", "9", "-R", "75", "-s", "7", "-n", "64", "-t", "99"], "PUSCH test OK", False),
    ("ulsim-mimo2x2", "ulsim", ["-m", "9", "-R", "106", "-W", "2", "-y", "2", "-s", "11", "-n", "64", "-t", "99"], "PUSCH test OK", False),
    ("dlsim-mcs9-106", "dlsim", ["-m", "9", "-R", "106", "-s", "5", "-n", "100", "-t", "99"], "PDSCH test OK", True),
    ("dlsim-mcs27-256qam", "dlsim", ["-m", "26", "-q", "2", "-R", "106", "-s", "27", "-n", "32", "-t", "99"], "PDSCH test OK", False),
    # CSI-RS scheduled INSIDE the PDSCH allocation, data rate-matched
    # around it (gNB_scheduler_dlsch.c:62 sched_csirs analog; r5)
    ("dlsim-csirs-ratematch", "dlsim", ["-m", "9", "-R", "106", "-s", "5", "-n", "64", "--csirs", "-t", "99"], "PDSCH test OK", False),
    # nr_pucchsim matrix (test_case_list.xml:279-323): F0 1/2-bit at -2 dB,
    # F2 3..11 bits on 1 PRB at the ref ramp, F2 12..64 bits at -3 dB
    ("pucchsim-f0-1bit", "pucchsim", ["-f", "0", "-b", "1", "-s", "-2", "-n", "256"], "PUCCH test OK", True),
    ("pucchsim-f0-2bit", "pucchsim", ["-f", "0", "-b", "2", "-s", "-2", "-S", "2", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-3bit", "pucchsim", ["-f", "2", "-b", "3", "-s", "0", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-6bit", "pucchsim", ["-f", "2", "-b", "6", "-s", "2", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-11bit", "pucchsim", ["-f", "2", "-b", "11", "-s", "6", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-12bit-4prb", "pucchsim", ["-f", "2", "-b", "12", "-P", "4", "-s", "-3", "-S", "2", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-19bit-8prb", "pucchsim", ["-f", "2", "-b", "19", "-P", "8", "-s", "-3", "-S", "2", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-32bit-16prb", "pucchsim", ["-f", "2", "-b", "32", "-P", "16", "-s", "-3", "-S", "2", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f2-64bit-16prb", "pucchsim", ["-f", "2", "-b", "64", "-P", "16", "-s", "-3", "-S", "3", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f1-1bit", "pucchsim", ["-f", "1", "-b", "1", "-s", "-2", "-n", "256"], "PUCCH test OK", False),
    ("pucchsim-f3-11bit", "pucchsim", ["-f", "3", "-b", "11", "-s", "0", "-S", "2", "-n", "256"], "PUCCH test OK", False),
    # nr_prachsim matrix (test_case_list.xml:491-513; SNR provenance above)
    ("prachsim-1-A2-106", "prachsim", ["-a", "-s", "-30", "-S", "-24", "-n", "100", "-p", "63", "-R", "106"], "PRACH test OK", True),
    ("prachsim-2-A2-217", "prachsim", ["-a", "-s", "-30", "-n", "100", "-p", "63", "-R", "217"], "PRACH test OK", False),
    ("prachsim-3-A2-273", "prachsim", ["-a", "-s", "-30", "-n", "100", "-p", "63", "-R", "273"], "PRACH test OK", False),
    ("prachsim-4-fmt0-106", "prachsim", ["-a", "-s", "-30", "-n", "100", "-p", "63", "-R", "106", "-c", "4"], "PRACH test OK", False),
    ("prachsim-5-A2-32-120kHz", "prachsim", ["-a", "-s", "-30", "-S", "-18", "-n", "100", "-p", "32", "-R", "32", "-m", "3", "-c", "52"], "PRACH test OK", False),
    ("prachsim-6-A2-66-120kHz", "prachsim", ["-a", "-s", "-30", "-S", "-26", "-n", "100", "-p", "32", "-R", "66", "-m", "3", "-c", "52"], "PRACH test OK", False),
    ("prachsim-7-highspeed", "prachsim", ["-a", "-s", "-30", "-S", "-22", "-n", "100", "-R", "66", "-m", "3", "-c", "52", "-H"], "PRACH test OK", False),
    ("prachsim-8-25prb-15kHz", "prachsim", ["-a", "-s", "-30", "-S", "-16", "-n", "100", "-p", "99", "-R", "25", "-m", "0"], "PRACH test OK", False),
    ("prachsim-9-fmt0-restricted", "prachsim", ["-a", "-s", "-30", "-n", "100", "-R", "106", "-c", "4", "-H"], "PRACH test OK", False),
    ("ulschsim-mcs9", "ulschsim", ["-m", "9", "-R", "106", "-s", "6", "-n", "32"], "ULSCH test OK", False),
    ("dlschsim-mcs15", "dlschsim", ["-m", "15", "-R", "106", "-s", "10", "-n", "32"], "DLSCH test OK", False),
    # NB-IoT core (r5): sync + NPBCH repetition gain + NPDSCH/NPUSCH +
    # NPRACH in one gate
    ("nbiotsim", "nbiotsim", ["-n", "8"], "NB-IoT test OK", False),
    # lte-softmodem loop: RRC connect inside TBs + scheduled data both
    # directions with PUCCH 1a/2 feedback (runtime/lte_softmodem.py)
    ("lte-softmodem-loop", "lte_softmodem_sim", ["--cycles", "4"],
     "LTE softmodem loop OK", False),
    # LTE legacy stack (dlsim/ulsim analogs of the eNB physims)
    ("lte-dlsim-mcs10", "lte_dlsim", ["-m", "10", "-R", "25", "-s", "12", "-n", "16", "-t", "99"], "LTE PDSCH test OK", False),
    ("lte-ulsim-mcs16-2rx", "lte_ulsim", ["-m", "16", "-R", "25", "-s", "14", "-n", "16", "-t", "99", "-y", "2"], "LTE PUSCH test OK", False),
    # 3GPP G-FR1-A5-13 (40 MHz, 30 kHz SCS, 2 RX, TDL-A 10ns, 2 HARQ
    # rounds, 7 iters): 70% TP at 12.4 dB (test_case_list.xml:457)
    ("ulsim-conformance-GFR1A513", "ulsim",
     ["-m", "20", "-R", "106", "-y", "2", "-g", "TDLA", "--delay-spread", "10",
      "-M", "2", "-I", "7", "-s", "12.4", "-n", "128", "--batch", "16", "-t", "70",
      "-D", "1", "--chest-window", "16"], "PUSCH test OK", False),
    # one conformance point under 100 Hz HST Doppler (VERDICT r3 item 4)
    ("ulsim-GFR1A513-doppler100", "ulsim",
     ["-m", "20", "-R", "106", "-y", "2", "-g", "TDLA", "--delay-spread", "10",
      "-M", "2", "-I", "7", "-s", "13.4", "-n", "128", "--batch", "16", "-t", "70",
      "-D", "1", "--chest-window", "16", "--doppler", "100"], "PUSCH test OK", False),
]


def _gpp(mu, prb, n_rx, snr, iters=7, mcs=20, layers=1, chan="TDLA", ds="10"):
    """One nr_ulsim.3gpp conformance point (test_case_list.xml:427-489):
    MCS20 (or the MIMO variants), TDL channel, 2 HARQ rounds, >=70% eff
    throughput at the listed SNR.  The batch sizes are the JAX package's,
    so both draw the same number of trials per batch."""
    batch = "16" if (n_rx >= 4 or prb >= 217) else "32"
    # --backend kernel: the conformance matrix exercises the production
    # decode path (K1, layered min-sum); at equal iteration count the
    # layered schedule converges at least as fast as the reference's
    # flooding schedule, so the reference SNR gates are the same or harder
    argv = ["-m", str(mcs), "-R", str(prb), "-u", str(mu), "-y", str(n_rx),
            "-g", chan, "--delay-spread", ds, "-M", "2", "-I", str(iters),
            "-s", str(snr), "-n", "128", "--batch", batch, "-t", "70", "-D", "1",
            "--chest-window", "16", "--backend", "kernel"]
    if layers > 1:
        argv += ["-W", str(layers)]
    return argv


# The reference CI's full nr_ulsim.3gpp matrix (28 points) + nr_ulsim.mimo.
# Same numerology/PRB/RX/SNR operating points; pass gate identical
# ("PUSCH test OK" at eff TP >= 70%).
CONFORMANCE_CASES = [
    ("3gpp-01-A5-13-40MHz-2rx", _gpp(1, 106, 2, 12.4)),
    ("3gpp-02-A5-13-40MHz-4rx", _gpp(1, 106, 4, 8.5)),
    ("3gpp-03-A5-13-40MHz-8rx", _gpp(1, 106, 8, 5.4)),
    ("3gpp-04-A5-8-5MHz-2rx", _gpp(0, 25, 2, 12.5)),
    ("3gpp-05-A5-8-5MHz-4rx", _gpp(0, 25, 4, 8.9)),
    ("3gpp-06-A5-8-5MHz-8rx", _gpp(0, 25, 8, 5.7)),
    ("3gpp-07-A5-9-10MHz-2rx", _gpp(0, 52, 2, 12.6)),
    ("3gpp-08-A5-9-10MHz-4rx", _gpp(0, 52, 4, 8.9)),
    ("3gpp-09-A5-9-10MHz-8rx", _gpp(0, 52, 8, 5.8)),
    ("3gpp-10-A5-10-20MHz-2rx", _gpp(0, 106, 2, 12.3)),
    ("3gpp-11-A5-10-20MHz-4rx", _gpp(0, 106, 4, 8.8)),
    ("3gpp-12-A5-10-20MHz-8rx", _gpp(0, 106, 8, 5.7)),
    ("3gpp-13-A5-11-10MHz-2rx", _gpp(1, 24, 2, 12.5)),
    ("3gpp-14-A5-11-10MHz-4rx", _gpp(1, 24, 4, 8.6)),
    ("3gpp-15-A5-11-10MHz-8rx", _gpp(1, 24, 8, 5.6)),
    ("3gpp-16-A5-12-20MHz-2rx", _gpp(1, 51, 2, 12.5)),
    ("3gpp-17-A5-12-20MHz-4rx", _gpp(1, 51, 4, 8.6)),
    ("3gpp-18-A5-12-20MHz-8rx", _gpp(1, 51, 8, 5.6)),
    ("3gpp-19-A5-13-40MHz-2rx", _gpp(1, 106, 2, 12.5)),
    ("3gpp-20-A5-13-40MHz-4rx", _gpp(1, 106, 4, 8.7)),
    ("3gpp-21-A5-13-40MHz-8rx", _gpp(1, 106, 8, 5.5)),
    ("3gpp-22-A5-14-100MHz-2rx", _gpp(1, 273, 2, 13.1)),
    ("3gpp-23-A5-14-100MHz-4rx", _gpp(1, 273, 4, 9.2)),
    ("3gpp-24-A5-14-100MHz-8rx", _gpp(1, 273, 8, 5.9, iters=8)),
    ("3gpp-25-A3-27-2layer-2rx", _gpp(1, 106, 2, 1.7, iters=15, mcs=2,
                                      layers=2, chan="TDLB", ds="30")),
    ("3gpp-26-A3-27-2layer-4rx", _gpp(1, 106, 4, -2.1, iters=15, mcs=2,
                                      layers=2, chan="TDLB", ds="30")),
    ("3gpp-27-A4-27-2layer-2rx", _gpp(1, 106, 2, 18.7, iters=15, mcs=16,
                                      layers=2, chan="TDLC", ds="30")),
    ("3gpp-28-A4-27-2layer-4rx", _gpp(1, 106, 4, 11.2, iters=15, mcs=16,
                                      layers=2, chan="TDLC", ds="30")),
    # nr_ulsim.mimo matrix (test_case_list.xml:409-425), AWGN
    # mimo set: the production path (K1) with the JAX package's batch caps
    ("mimo-1-mcs19-50prb-2rx", ["-m", "19", "-R", "50", "-y", "2", "-s", "15",
                                "-n", "64", "-t", "99", "--batch", "32",
                                "--backend", "kernel"]),
    ("mimo-2-mcs9-2layer", ["-m", "9", "-R", "106", "-W", "2", "-y", "2",
                            "-s", "8", "-n", "64", "-t", "85",
                            "--batch", "16", "--backend", "kernel"]),
    ("mimo-3-mcs10-2layer", ["-m", "10", "-R", "106", "-W", "2", "-y", "2",
                             "-s", "12", "-n", "64", "-t", "99",
                             "--batch", "16", "--backend", "kernel"]),
    ("mimo-4-mcs19-2layer", ["-m", "19", "-R", "106", "-W", "2", "-y", "2",
                             "-s", "22", "-n", "64", "-t", "99",
                             "--batch", "16", "--backend", "kernel"]),
    ("mimo-5-mcs9-4layer", ["-m", "9", "-R", "106", "-W", "4", "-y", "4",
                            "-s", "10", "-n", "64", "-t", "85",
                            "--batch", "8", "--backend", "kernel"]),
]


# Simulators the port lacks, with the ROADMAP.md Queue 1 item that brings them
# (none: every case of the JAX package's lists runs through the port)
NOT_PORTED: dict[str, int] = {}
_NOT_PORTED_RE = re.compile(r"is not ported yet: ROADMAP\.md Queue 1 item (\d+)")
_SNR_RE = re.compile(r"^SNR\s+(-?[0-9.]+) dB")


class Result(NamedTuple):
    case: str
    status: str            # 'PASS' | 'FAIL' | 'NOT PORTED'
    seconds: float
    first_snr_line: str    # the simulator's first SNR line ('' if none)
    last_snr_db: float | None   # the SNR of its last SNR line
    item: int | None       # ROADMAP.md Queue 1 item of a NOT PORTED case
    output: str


def run_case(module: str, argv: list[str], isolate: bool = False) -> str:
    """Run one simulator CLI; returns what it printed.  A NotImplementedError
    (a branch the port lacks) is printed into the output, as a separate
    process prints it."""
    if isolate:
        # one OS process per case (run_exec_autotests also execs each case)
        r = subprocess.run(
            [sys.executable, "-m", f"openairinterface5g_tpu_torch.sim.{module}"]
            + argv, capture_output=True, text=True, timeout=3600)
        return r.stdout + r.stderr
    mod = importlib.import_module(f"openairinterface5g_tpu_torch.sim.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            mod.main(argv)
        except SystemExit:
            pass
        except NotImplementedError as e:
            print(f"NotImplementedError: {e}")
    return buf.getvalue()


def judge(case: str, module: str, argv: list[str], pass_str: str,
          isolate: bool = False, device: str = "cuda") -> Result:
    """Run one case (unless its simulator is not ported) and judge it."""
    if module in NOT_PORTED:
        return Result(case, "NOT PORTED", 0.0, "", None, NOT_PORTED[module], "")
    t0 = time.time()
    out = run_case(module, [*argv, "--device", device], isolate=isolate)
    dt = time.time() - t0
    snr_lines = [line for line in out.splitlines() if _SNR_RE.match(line)]
    missing = _NOT_PORTED_RE.search(out)
    if missing:
        status, item = "NOT PORTED", int(missing.group(1))
    else:
        status, item = ("PASS" if pass_str in out else "FAIL"), None
    last = float(_SNR_RE.match(snr_lines[-1]).group(1)) if snr_lines else None
    return Result(case, status, dt, snr_lines[0] if snr_lines else "", last, item, out)


def report(r: Result) -> None:
    """Print one case's verdict lines."""
    if r.status == "NOT PORTED":
        print(f"[NOT PORTED] {r.case} (ROADMAP.md Queue 1 item {r.item})")
        return
    print(f"[{r.status}] {r.case} ({r.seconds:.1f}s)")
    print(f"  first: {r.first_snr_line}")
    if r.last_snr_db is not None:
        print(f"  {'passed' if r.status == 'PASS' else 'last'} at {r.last_snr_db:.2f} dB")
    if r.status == "FAIL":
        print("  --- output tail ---")
        print("  " + "\n  ".join(r.output.strip().splitlines()[-5:]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--conformance", action="store_true",
                    help="run the 28-point nr_ulsim.3gpp matrix + mimo set")
    ap.add_argument("--filter", type=str, default="")
    ap.add_argument("--isolate", action="store_true",
                    help="run each case in its own OS process")
    ap.add_argument("--device", default="cuda", help="cuda or cpu, for every case")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    case_list = list(CASES)
    if args.conformance:
        case_list = [(cid, "ulsim", cargv, "PUSCH test OK", True)
                     for cid, cargv in CONFORMANCE_CASES]

    results = []
    for cid, module, case_argv, pass_str, quick in case_list:
        if not args.full and not args.conformance and not quick:
            continue
        if args.filter and args.filter not in cid:
            continue
        r = judge(cid, module, case_argv, pass_str, args.isolate, args.device)
        report(r)
        results.append(r)
    ran = [r for r in results if r.status != "NOT PORTED"]
    n_ok = sum(r.status == "PASS" for r in ran)
    print(f"\n{n_ok}/{len(ran)} autotests passed, "
          f"{len(results) - len(ran)} not ported")
    return 0 if n_ok == len(ran) else 1


if __name__ == "__main__":
    sys.exit(main())
