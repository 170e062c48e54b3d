#!/usr/bin/env python3
"""The LDPC decoders on one GPU: their device times, and where K1 layered's
time goes at the main path's tensors.

    python -m openairinterface5g_tpu_torch.tools.bench_ldpc_layered

Every time is device ms per call from torch.profiler's rows of the
decoder's own CUDA kernels (every row whose name holds ``ldpc_``), the
mean over ``CALLS`` calls after the profiler's own warm-up step.  Each
configuration is first held against ``decode_plain`` (bits and ok flags
equal), so a wrong kernel is never timed.

Rows (``ldpc_decoder.decode``, 8 iterations unless named):
  main            the main path's call: the 208 bf16 code blocks of one
                  8-slot 273-PRB 2x2 batch (``bench_launch.receiver``),
                  ``check_every=1``
  split n_iters=N check_every=C
                  the same tensors at (0, 0), (1, 0), (1, 1) and (8, 0)
  awgn ...        BG1 Z=384 x 208 random code blocks, BPSK over AWGN at
                  4 dB, punctured head at 0 (chip_smoke.py's decoder
                  phase), check_every 0 and 1, every variant: K1 layered
                  and flooding with f32 messages (f32 and bf16 input) and
                  int8 messages, K1 flooding with bf16 messages, and K2
                  (bf16 messages, layered; it ignores check_every)

The split of the main path's time, from the four split rows (T(n, c)):
  no iteration     T(0,0): reading the LLRs, the message or state set-up,
                   one syndrome check, writing bits and flags
  first iteration  T(1,0) - T(0,0)
  iteration        (T(8,0) - T(1,0)) / 7, one iteration after the first
  checks           T(1,1) - T(1,0), the checks the main path runs beyond
                   the one that ends every decode (one where each check
                   runs apart from the final flag's, none where a check
                   of the final totals gives the flag)

It prints one JSON line.  The port is imported by absolute name and
through its public entry points only, so this file also times another
checkout of the port, such as a parent commit:

    cd <checkout> && PYTHONPATH=$PWD python <path of this file>

Alternating pairs of such processes (parent, change, change, parent, ...)
in one session compare two versions on the same card.

Without CUDA it raises: these are device measurements.
"""
from __future__ import annotations

import json

import torch

from openairinterface5g_tpu_torch.coding import ldpc
from openairinterface5g_tpu_torch.ops import ldpc_decoder
from openairinterface5g_tpu_torch.tools import bench_launch

CALLS = 10
SNR_DB = 4.0
AWGN = (1, 384, 208)            # (bg, Z, code blocks)
SPLIT = ((0, 0), (1, 0), (1, 1), (8, 0))   # (n_iters, check_every)
# (label, schedule, message type, input type) of the AWGN rows
VARIANTS = (("layered f32", "layered", torch.float32, torch.float32),
            ("layered f32, bf16 input", "layered", torch.float32, torch.bfloat16),
            ("layered int8", "layered", torch.int8, torch.float32),
            ("flooding f32", "flooding", torch.float32, torch.float32),
            ("flooding f32, bf16 input", "flooding", torch.float32, torch.bfloat16),
            ("flooding int8", "flooding", torch.int8, torch.float32),
            ("flooding bf16", "flooding", torch.bfloat16, torch.float32),
            ("K2", "layered", torch.bfloat16, torch.float32))


def profiled_rows(fn, calls: int, keys: tuple) -> dict:
    """key -> (summed device µs, count) of the profiler rows whose name
    holds the key, over `calls` calls of fn in the active step of a
    profile whose first step is the profiler's own warm-up: kernels
    launched in the first milliseconds of a profile can go unrecorded."""
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                schedule=schedule) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    rows = prof.key_averages()
    return {k: (sum(e.self_device_time_total for e in rows if k in e.key),
                sum(e.count for e in rows if k in e.key)) for k in keys}


def device_ms(fn, calls: int, keys: tuple, attempts: int = 5) -> float:
    """Device ms per call of fn: per key, the mean of its profiler rows over
    `calls` calls, summed over the keys.  A profile that did not record
    every launch is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        found = profiled_rows(fn, calls, keys)
        if all(n == calls for _, n in found.values()):
            return sum(us / n for us, n in found.values()) / 1e3
    raise AssertionError(f"profiler recorded launches {found} in {calls} calls of {keys}")


def awgn_code_blocks(bg: int, Z: int, n_cb: int, dev, gen, snr_db: float = SNR_DB):
    """(graph, sent info bits, f32 LLRs) of random code blocks, BPSK over
    AWGN at snr_db, punctured systematic head set to 0."""
    g = ldpc.build_graph(bg, Z)
    info = torch.randint(0, 2, (n_cb, g.K), generator=gen, device=dev, dtype=torch.int8)
    cw = ldpc.encode(g, info).to(torch.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw) + sigma * torch.randn(cw.shape, generator=gen, device=dev)
    llr = 2 * y / sigma ** 2
    llr[:, : 2 * Z] = 0
    return g, info, llr


def _held(g, x, n_iters: int, **kw):
    """decode() of x, raising unless it equals decode_plain()."""
    bk, okk = ldpc_decoder.decode(g, x, n_iters, **kw)
    bp, okp = ldpc_decoder.decode_plain(g, x, n_iters, **kw)
    if not (torch.equal(bk, bp) and torch.equal(okk, okp)):
        raise AssertionError(f"decode n_iters={n_iters} {kw}: kernel differs from plain")
    return lambda: ldpc_decoder.decode(g, x, n_iters, **kw)


def split(g, llr: torch.Tensor, calls: int = CALLS) -> dict:
    """The split rows at (g, llr) and the split derived from them (ms)."""
    t = {f"n_iters={n} check_every={c}": device_ms(_held(g, llr, n, check_every=c), calls,
                                                     ("ldpc_",))
         for n, c in SPLIT}
    t00, t10, t11, t80 = t.values()
    return {"times": t, "no_iteration": t00, "first_iteration": t10 - t00,
            "iteration": (t80 - t10) / 7, "checks": t11 - t10}


def run() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_ldpc_layered measures the decoders on a GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rcv = bench_launch.receiver(dev, gen)
    g, llr = rcv.graph, rcv.llr
    out = {"device": torch.cuda.get_device_name(dev), "calls": CALLS,
           "main": device_ms(_held(g, llr, bench_launch.MAIN_PATH_ITERS, check_every=1),
                             CALLS, ("ldpc_",)),
           "split": split(g, llr), "awgn": {}}
    ga, _, la = awgn_code_blocks(*AWGN, dev, gen)
    for label, schedule, msg_dtype, in_dtype in VARIANTS:
        x = la.to(in_dtype).contiguous()
        for ce in (0, 1):
            fn = _held(ga, x, 8, schedule=schedule, msg_dtype=msg_dtype, check_every=ce)
            out["awgn"][f"{label} check_every={ce}"] = device_ms(fn, CALLS, ("ldpc_",))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
