#!/usr/bin/env python3
"""Run the over-the-air endpoints as two OS processes over the rfsim hub, and
write their records from a run on one GPU.

    python -m openairinterface5g_tpu_torch.tools.ota_records [--out-dir DIR]
        [--cycles 30]

* ``RA_OTA_torch.txt``: ``runtime/ra_ota.py``'s gNB and UE processes,
* ``CONNECTED_OTA_torch.txt``: ``runtime/connected_ota.py``, ``--cycles``
  4-slot cycles,
* ``CONNECTED_OTA_L2_torch.txt``: the same with the PDCP/RLC user plane
  (``--l2``),

each under a header with the card's name and power limit, the session's
wall seconds, each endpoint's K3/K1 launches and its time by stage (each
stage's calls ended by a synchronize), then the gNB process's lines and the
UE process's, as the JAX package's records (``RA_OTA_r4.txt``,
``CONNECTED_OTA_r5.txt``, ``CONNECTED_OTA_L2_r5.txt``) hold them, and last
every line that differs from the JAX record's.  Without CUDA it raises.

``session()`` is the two-process run (``chip_smoke.py`` phase 12 drives it
too); ``endpoint`` is the child process's own entry:

    python -m openairinterface5g_tpu_torch.tools.ota_records endpoint
        ra|connected gnb|ue --port P [--cycles N] [--l2] [--device cpu]

It builds the kernels and the hub, prints ``READY``, runs the endpoint's
own CLI (``runtime/ra_ota.py`` or ``connected_ota.py``, on the card), and
prints a last line ``ENDPOINT {json}``: the endpoint's result, its K1
(layered f32) and K3 launches, its wall seconds and its seconds by stage.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RECORDS = {"ra": "RA_OTA_r4.txt", "connected": "CONNECTED_OTA_r5.txt",
           "connected_l2": "CONNECTED_OTA_L2_r5.txt"}
# per endpoint, the calls timed by stage (module attributes of the loop)
STAGES = {
    ("connected", "gnb"): {"gnb_dl_slot": ("gnb_dl_slot",), "pusch_rx_grid": ("pusch_rx_grid",),
                           "pucch_rx": ("pucch0_rx", "pucch2_rx")},
    ("connected", "ue"): {"ue_receive_slot": ("ue_receive_slot",),
                          "blind_search (UL grant)": ("blind_search",),
                          "pusch_channel_estimate (CQI)": ("pusch_channel_estimate",),
                          "pusch_tx": ("pusch_tx",)},
}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _timed(mod, stages: dict, seconds: dict, sync) -> None:
    """Wrap each stage's calls in `mod` so they end in sync() and add their
    seconds to seconds[stage]."""

    for stage, names in stages.items():
        seconds[stage] = 0.0
        for name in names:
            fn = getattr(mod, name)

            def call(*a, _fn=fn, _stage=stage, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                sync()
                seconds[_stage] += time.perf_counter() - t0
                return out
            setattr(mod, name, call)


def endpoint(kind: str, role: str, port: int, n_cycles: int, l2: bool,
             device: str = "cuda") -> int:
    """One endpoint in this process, on `device`, through its module's CLI
    (the child of session()); returns the CLI's exit code."""
    import torch

    from ..ops import _cuda, ldpc_decoder
    from ..ops import pusch_frontend as fe
    from ..radio import rfsim
    from ..runtime import connected_ota, ra_ota

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        _cuda.route()
    rfsim._load()
    mod = ra_ota if kind == "ra" else connected_ota
    seconds: dict = {}
    _timed(mod, STAGES.get((kind, role), {}), seconds, sync)
    run_name = "run_gnb" if role == "gnb" else "run_ue"
    run, kept = getattr(mod, run_name), {}

    def keep(*a, **kw):
        kept["result"] = run(*a, **kw)
        return kept["result"]
    setattr(mod, run_name, keep)
    fe.launches = 0
    for k in ldpc_decoder.launches:
        ldpc_decoder.launches[k] = 0
    argv = [role, "--port", str(port), "--device", device]
    if kind == "connected":
        argv += ["--slots", str(4 * n_cycles)] + (["--l2"] if l2 else [])
    print("READY", flush=True)
    t0 = time.perf_counter()
    rc = mod.main(argv)
    sync()
    wall = time.perf_counter() - t0
    result = kept.get("result")
    if isinstance(result, dict):
        result = {k: v for k, v in result.items() if k != "mcs_trace"}
    print("ENDPOINT " + json.dumps({
        "result": result, "wall_s": wall, "stages_s": seconds,
        "launches": {"pusch_frontend": fe.launches,
                     "layered_f32": ldpc_decoder.launches["layered_f32"]}}), flush=True)
    return rc


def _start(kind: str, role: str, port: int, n_cycles: int, l2: bool,
           device: str) -> subprocess.Popen:
    argv = [sys.executable, "-m", "openairinterface5g_tpu_torch.tools.ota_records", "endpoint",
            kind, role, "--port", str(port), "--cycles", str(n_cycles), "--device", device]
    argv += ["--l2"] if l2 else []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)


def session(kind: str, port: int, n_cycles: int = 8, l2: bool = False,
            timeout_s: float = 600.0, device: str = "cuda") -> dict:
    """The gNB and the UE endpoint as two OS processes over the hub: the gNB
    starts first and the UE once the gNB is ready.  Returns per role its log
    lines, its ENDPOINT record and its whole output; the session's wall
    seconds from the UE's start to the last exit.  A process that fails or
    outlives timeout_s raises; both are stopped in every case."""
    procs = {}
    try:
        procs["gnb"] = _start(kind, "gnb", port, n_cycles, l2, device)
        out = {"gnb": [], "ue": []}
        for line in procs["gnb"].stdout:
            out["gnb"].append(line.rstrip("\n"))
            if line.startswith("READY"):
                break
        else:
            raise RuntimeError(f"{kind} gNB endpoint exited before it was ready:\n"
                               + "\n".join(out["gnb"]))
        t0 = time.perf_counter()
        procs["ue"] = _start(kind, "ue", port, n_cycles, l2, device)
        rest = {role: p.communicate(timeout=timeout_s)[0] for role, p in procs.items()}
        wall = time.perf_counter() - t0
        res = {"wall_s": wall}
        for role, p in procs.items():
            text = out[role] + rest[role].splitlines()
            if p.returncode != 0:
                raise RuntimeError(f"{kind} {role} endpoint exited {p.returncode}:\n"
                                   + "\n".join(text[-40:]))
            ends = [x for x in text if x.startswith("ENDPOINT ")]
            if not ends:
                raise RuntimeError(f"{kind} {role} endpoint printed no result:\n"
                                   + "\n".join(text[-40:]))
            res[role] = {"lines": [x for x in text if x.startswith(f"[{role}]")],
                         "output": text, **json.loads(ends[-1][len("ENDPOINT "):])}
        return res
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def differences(lines: list[str], record: str, prefix: str) -> list[tuple]:
    """(index, port's line, record's line) for each line with `prefix` that
    differs from the JAX record's in order (None where one side ends)."""
    want = [x for x in (ROOT / record).read_text().splitlines() if x.startswith(prefix)]
    got = [x for x in lines if x.startswith(prefix)]
    n = max(len(got), len(want))
    pad = lambda xs: xs + [None] * (n - len(xs))   # noqa: E731
    return [(i, g, w) for i, (g, w) in enumerate(zip(pad(got), pad(want))) if g != w]


def _stage_line(rec: dict, n_cycles: int) -> str:
    per = {k: 1e3 * v / n_cycles for k, v in rec["stages_s"].items()}
    return ", ".join(f"{k} {v:.1f}" for k, v in per.items())


def write_record(path: Path, kind: str, key: str, res: dict, title: str, n_cycles: int,
                 card_line: str) -> list[tuple]:
    """The record file of one session, held to the JAX record RECORDS[key];
    returns its differences from the JAX record's lines, for each endpoint whose lines the record holds (the
    connected-mode records hold the gNB process's only)."""
    record = (ROOT / RECORDS[key]).read_text().splitlines()
    prefixes = [p for p in ("[gnb]", "[ue]") if any(x.startswith(p) for x in record)]
    diffs = {p: differences(res[p[1:-1]]["lines"], RECORDS[key], p) for p in prefixes}
    head = [f"# {title}",
            f"# card: {card_line}",
            f"# session wall {res['wall_s']:.1f} s (UE start to last exit), "
            + (f"{n_cycles} cycles, {1e3 * res['wall_s'] / n_cycles:.1f} ms per cycle"
               if kind != "ra" else "6 slots"),
            *(f"# {role}: launches {res[role]['launches']}, {res[role]['wall_s']:.1f} s"
              + (f"; ms per cycle by stage: {_stage_line(res[role], n_cycles)}"
                 if res[role]["stages_s"] else "") for role in ("gnb", "ue")),
            f"# against {RECORDS[key]}: "
            + ", ".join(f"{p} {len(d)} lines differ" for p, d in diffs.items()),
            "#"]
    body = []
    for role in ("gnb", "ue"):
        body += [f"== {'gNB' if role == 'gnb' else 'UE'} process =="]
        body += [x for x in res[role]["output"] if not x.startswith(("READY", "ENDPOINT "))]
        body += [""]
    tail = [f"# differs from {RECORDS[key]} at {p} line {i}: port {g!r}, record {w!r}"
            for p, d in diffs.items() for i, g, w in d]
    path.write_text("\n".join(head + body + tail) + "\n")
    return [x for d in diffs.values() for x in d]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd")
    ep = sub.add_parser("endpoint")
    ep.add_argument("kind", choices=["ra", "connected"])
    ep.add_argument("role", choices=["gnb", "ue"])
    ep.add_argument("--port", type=int, required=True)
    ep.add_argument("--cycles", type=int, default=8)
    ep.add_argument("--l2", action="store_true")
    ep.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out-dir", type=str, default=".")
    ap.add_argument("--cycles", type=int, default=30)
    args = ap.parse_args(argv)
    if args.cmd == "endpoint":
        return endpoint(args.kind, args.role, args.port, args.cycles, args.l2, args.device)

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the records are the card's")
    card_line = card()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    runs = (("ra", False, "ra", "RA_OTA_torch.txt",
             "Over-the-air random access, the port on the card"),
            ("connected", False, "connected", "CONNECTED_OTA_torch.txt",
             "Connected-mode data plane over the air, the port on the card"),
            ("connected", True, "connected_l2", "CONNECTED_OTA_L2_torch.txt",
             "Connected-mode OTA with the PDCP(NEA2)+RLC-AM user plane (--l2), the port on "
             "the card"))
    for i, (kind, l2, key, name, title) in enumerate(runs):
        res = session(kind, 48801 + i, args.cycles, l2, timeout_s=3000)
        diffs = write_record(out / name, kind, key, res, title, args.cycles, card_line)
        print(f"{name}: session {res['wall_s']:.1f} s, {len(diffs)} lines differ from "
              f"{RECORDS[key]}; gNB result {res['gnb']['result']}", flush=True)
        for d in diffs:
            print(f"  line {d[0]}: port {d[1]!r} / record {d[2]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
