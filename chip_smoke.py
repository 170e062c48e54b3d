#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Drives the port's two paths with every hand-written CUDA kernel:
  * slice 1, the PUSCH receive path (openairinterface5g_tpu_torch) at the
    100 MHz 2x2 configuration: 273 PRB, MCS 16, 2 layers, 2 RX antennas,
    8 slots per batch, 8 LDPC iterations (K3 and K1's layered f32 variant);
  * slice 2, the LDPC decoder's own entry point ``ops.ldpc_decoder.decode``
    (decode_pallas's signature) in each of its other variants (K1 flooding,
    int8 and bf16, K2), and the launch probes T1/T2 (``ops.tiny``).

Phases, one line or more each:
  1. device: the card's name and power limit (nvidia-smi); no GPU -> error
  2. build every kernel from csrc/ with nvcc (one process per source)
  3. K3 (fused frontend) against its plain PyTorch version, 20 and 273 PRB
  4. slice 1 main path: pusch_tx -> channel -> pusch_rx; every TB must pass
     CRC and equal the sent bits, both kernels must have launched; then the
     kernels held against their plain versions and timed at the main path's
     tensors, and slots/s over 20 batches
  5. the decoder's variants through decode() (slice 1's layered f32 with f32
     and bf16 input, and slice 2's), 4 dB, 8 iterations, BG1 Z=384 x 208
     and BG2 Z=104 x 64, check_every 0 and 1: kernel bits == plain bits ==
     sent bits, ok flags equal and all true, every kernel launched; then
     kernel and plain times at BG1 Z=384 x 208 for both check_every
  6. slice 2 launch probes: T1/T2 against their plain version and x * 2
The line before the last is {"kernels": [...]}: every kernel with its
launches, and the error, times and bound of one configuration (slice 1's
kernels at the main path's tensors; the other decoders at BG1 Z=384 x 208,
check_every=1, f32 input, with check_every=0 under *_check_every_0 keys).
The last line is {"ok": true,
"device": {...}}.  Any failure raises and exits non-zero.  Imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

from openairinterface5g_tpu_torch.coding import ldpc, rate_matching
from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import _cuda, ldpc_decoder, tiny
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate

SEED = 1234
B = 8                     # slots per batch
N_ITERS = 8
K3_TOL = 2e-4             # max |kernel - plain| / max |plain| of the LLR planes
N_TIMED = 20              # batches in the slots/s window
SNR_DB = 4.0              # decoder phases: BPSK over AWGN at this Es/N0
DECODER_SIZES = ((1, 384, 208), (2, 104, 64))   # (bg, Z, code blocks)

# Roofline of one H100 SXM (NVIDIA data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.  The decoders compute every operation on 32-bit
# lanes (bf16 in f32, int8 messages in int32), so f32's rate is their peak.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per edge, lane and iteration of min-sum: v = t - o, |v|, three
# for min1/min2, sign xor, the excluded-min compare and select, scale, the
# sign select, and the two operations of the total update (flooding: one
# add in the variable-node pass and no update); per edge and lane of a
# syndrome check: load compare and xor
OPS_PER_EDGE_ITER = 12
OPS_PER_EDGE_CHECK = 2

# (label, kernel name, schedule, message type, input type); the first row of
# a kernel (f32 input) is the one the kernels line reports
VARIANTS = (
    ("layered f32", "layered_f32", "layered", torch.float32, torch.float32),
    ("layered f32, bf16 input", "layered_f32", "layered", torch.float32, torch.bfloat16),
    ("flooding f32", "flooding_f32", "flooding", torch.float32, torch.float32),
    ("flooding f32, bf16 input", "flooding_f32", "flooding", torch.float32, torch.bfloat16),
    ("int8 layered", "layered_int8", "layered", torch.int8, torch.float32),
    ("int8 flooding", "flooding_int8", "flooding", torch.int8, torch.float32),
    ("bf16 flooding", "flooding_bf16", "flooding", torch.bfloat16, torch.float32),
    ("K2 bf16 layered", "layered_bf16", "layered", torch.bfloat16, torch.float32),
)
K1_SRC = "openairinterface5g_tpu_torch/csrc/ldpc_decoder.cu"
K1_TPU = "openairinterface5g_tpu/ops/ldpc_pallas.py:61"
KERNEL_SOURCES = {
    "layered_f32": (K1_SRC, K1_TPU), "flooding_f32": (K1_SRC, K1_TPU),
    "layered_int8": (K1_SRC, K1_TPU), "flooding_int8": (K1_SRC, K1_TPU),
    "flooding_bf16": (K1_SRC, K1_TPU),
    "layered_bf16": ("openairinterface5g_tpu_torch/csrc/ldpc_decoder_bf16.cu",
                     "openairinterface5g_tpu/ops/ldpc_pallas.py:383"),
    "pusch_frontend": ("openairinterface5g_tpu_torch/csrc/pusch_frontend.cu",
                       "openairinterface5g_tpu/ops/pusch_frontend_pallas.py:162"),
    "tiny": ("openairinterface5g_tpu_torch/csrc/tiny.cu", "tools/bench_overhead.py:53"),
    "tiny_grid": ("openairinterface5g_tpu_torch/csrc/tiny.cu", "tools/bench_overhead.py:81"),
}


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _decoder_bound(g, x: torch.Tensor, iters: torch.Tensor,
                   check_every: int) -> tuple[float, str]:
    """K1/K2's bound for one decode of `x`: the input read once, bits and
    flags written once, and the operations of the iterations each code
    block actually ran (`iters`, from the plain version's early stop)."""
    E = int(g.evalid.sum())
    n_bytes = x.numel() * x.element_size() + x.shape[0] * (g.K + 1)
    it = float(iters.sum())
    n_checks = float((iters // check_every).sum()) if check_every else 0.0
    n_ops = E * g.Z * (OPS_PER_EDGE_ITER * it + OPS_PER_EDGE_CHECK * (n_checks + x.shape[0]))
    return _bound(n_bytes, n_ops)


def _k3_ops(cfg) -> int:
    """Arithmetic operations of one K3 call (B slots), counted from the
    kernel body in csrc/pusch_frontend.cu: a complex multiply is 6, a
    complex add 2, |z|^2 3, a divide, select or fabs 1; index arithmetic is
    not counted."""
    P, R, qm = cfg.n_layers, cfg.n_rx, cfg.qm_rate[0]
    n_dmrs, n_data, w = len(cfg.dmrs_symbols), len(cfg.data_symbols), cfg.chest_window
    n_pil, M = 6 * cfg.n_prb, 12 * cfg.n_prb
    # estimate_kernel, per antenna and pilot: LS and its sum per DMRS symbol
    # (8; 1 layer: the adjacent-pilot noise term, 12 more) and the mean (2);
    # 2 layers: the OCC split (8) and the pair-difference noise term on
    # every second pilot (20); per port the replicate-padded window sum
    # and mean (2w + 2); per port and subcarrier, the off-comb half
    # interpolated (4 each, 2 on average)
    per_pilot = n_dmrs * (8 + (12 if P == 1 else 0)) + 2 + (18 if P == 2 else 0)
    per_pilot += P * (2 * w + 2) if w > 1 else 0
    est = R * (n_pil * per_pilot + P * M * 2)
    # equalize_llr_kernel, per data RE: per antenna the matched filter and
    # gain of each layer (12), 2 layers the cross term (8) too; the closed-
    # form 2x2 MMSE (38); per layer the qm max-log LLRs and their
    # descrambling selects
    llr = {2: 2, 4: 5, 6: 10, 8: 15}[qm]
    per_re = R * (12 if P == 1 else 32) + (38 if P == 2 else 0) + P * (llr + qm)
    return B * (est + n_data * M * per_re)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.library()
    print(f"build: {so.name} from {len(_cuda.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s")


def _rx_grid(cfg, dev, gen, noise=0.05):
    """A received RE grid: random TBs through pusch_tx_grid, a fixed random
    2x2 mixing channel and complex AWGN."""
    tb = torch.randint(0, 2, (B, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    grid_re, _ = pusch.pusch_tx_grid(cfg, tb)
    h = torch.complex(torch.randn((cfg.n_rx, cfg.n_layers), generator=gen, device=dev),
                      torch.randn((cfg.n_rx, cfg.n_layers), generator=gen, device=dev)) / 2 ** 0.5
    y = torch.einsum("rl,blsm->brsm", h, grid_re)
    n = torch.complex(torch.randn(y.shape, generator=gen, device=dev),
                      torch.randn(y.shape, generator=gen, device=dev))
    return (y + noise * n).contiguous()


def _k3_check(tag: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """K3 output against its plain version: returns max |kernel - plain|;
    raises on a shape, a non-finite value or a relative error >= K3_TOL."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K3 {tag}: shape {tuple(got.shape)} or non-finite")
    abs_err = float((got - ref).abs().max())
    err = abs_err / float(ref.abs().max())
    if not err < K3_TOL:
        raise AssertionError(f"K3 {tag}: relative error {err:.3e} >= {K3_TOL}")
    print(f"K3 pusch_frontend {tag}: max err / max|LLR| = {err:.3e} "
          f"(max abs err {abs_err:.3e})")
    return abs_err


def phase_frontend(dev, gen) -> None:
    for n_prb in (20, 273):
        cfg = pusch.PuschConfig(mu=1, n_prb=n_prb, mcs=16, n_layers=2, n_rx=2)
        y = _rx_grid(cfg, dev, gen)
        _k3_check(f"{n_prb} PRB B={B}", fe.frontend_planes(cfg, y),
                  fe.frontend_planes_plain(cfg, y))


def _awgn_code_blocks(bg, Z, n_cb, dev, gen):
    """(graph, sent info bits, f32 LLRs) of random code blocks, BPSK over
    AWGN at SNR_DB, punctured systematic head set to 0."""
    g = ldpc.build_graph(bg, Z)
    info = torch.randint(0, 2, (n_cb, g.K), generator=gen, device=dev, dtype=torch.int8)
    cw = ldpc.encode(g, info).to(torch.float32)
    sigma = 10 ** (-SNR_DB / 20)
    y = (1 - 2 * cw) + sigma * torch.randn(cw.shape, generator=gen, device=dev)
    llr = 2 * y / sigma ** 2
    llr[:, : 2 * Z] = 0
    return g, info, llr


def phase_main_path(dev, gen, card: str) -> dict:
    cfg = pusch.PuschConfig(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2,
                            decoder_backend="kernel", decoder_check_every=1)
    tb = torch.randint(0, 2, (B, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    tx, _ = pusch.pusch_tx(cfg, tb)
    noise = torch.complex(torch.randn(tx.shape, generator=gen, device=dev),
                          torch.randn(tx.shape, generator=gen, device=dev))
    rx = tx + 0.1 * tx.flip(1) + 0.05 * noise

    fe.launches = 0
    for k in ldpc_decoder.launches:
        ldpc_decoder.launches[k] = 0
    out = pusch.pusch_rx(cfg, rx, n_iters=N_ITERS)
    torch.cuda.synchronize()
    launches = {"pusch_frontend": fe.launches, "layered_f32": ldpc_decoder.launches["layered_f32"]}
    if min(launches.values()) < 1:
        raise AssertionError(f"main path missed a kernel: launches {launches}")
    n_ok = int(out["tb_ok"].sum())
    if n_ok != B or not torch.equal(out["tb_bits"], tb):
        raise AssertionError(f"main path: {n_ok}/{B} TBs pass CRC, bits equal: "
                             f"{torch.equal(out['tb_bits'], tb)}")
    p, _ = cfg.seg_params()
    print(f"main path: 273 PRB MCS16 2x2 B={B}: {n_ok}/{B} TBs pass CRC and equal the "
          f"sent bits ({B * p.C} code blocks); launches {launches}")

    # both kernels against their plain versions, then timed, at the main
    # path's own tensors
    fp = cfg.fp
    re_grid = extract_from_grid(fp, ofdm_demodulate(fp, rx, cfg.slot)).contiguous()
    g = ldpc.build_graph(p.bg, p.Z)
    planes = fe.frontend_planes(cfg, re_grid)
    errs = {"pusch_frontend": _k3_check(f"main path {cfg.n_prb} PRB B={B}", planes,
                                        fe.frontend_planes_plain(cfg, re_grid))}
    stacked = rate_matching.fused_rate_match_rx_planes(
        g, planes.to(torch.bfloat16), 0, tuple(cfg.cb_e_sizes()), cfg.qm_rate[0], p.F)
    llr = stacked.reshape(B * p.C, -1).contiguous()
    bk, okk = ldpc_decoder.decode(g, llr, N_ITERS, check_every=1)
    bp, okp, iters = ldpc_decoder.decode_plain(g, llr, N_ITERS, check_every=1,
                                               return_iters=True)
    if not (torch.equal(bk, bp) and torch.equal(okk, okp)):
        raise AssertionError("main path K1: kernel bits or ok flags differ from plain")
    errs["layered_f32"] = int((bk.int() - bp.int()).abs().max())
    print(f"K1 layered f32 at the main path's {B * p.C} code blocks (bf16 LLRs, "
          f"check_every=1): kernel == plain, {int(okk.sum())}/{okk.numel()} parity ok")
    times = {
        "pusch_frontend": (_time_ms(lambda: fe.frontend_planes(cfg, re_grid), 20),
                           _time_ms(lambda: fe.frontend_planes_plain(cfg, re_grid), 5)),
        "layered_f32": (_time_ms(lambda: ldpc_decoder.decode(g, llr, N_ITERS, check_every=1), 20),
                        _time_ms(lambda: ldpc_decoder.decode_plain(g, llr, N_ITERS, check_every=1), 3)),
    }
    bounds = {
        "layered_f32": _decoder_bound(g, llr, iters, 1),
        "pusch_frontend": _bound(
            re_grid.numel() * re_grid.element_size() + planes.numel() * planes.element_size(),
            _k3_ops(cfg)),
    }
    print(f"main path decode: {B * p.C} code blocks ran {float(iters.float().mean()):.3f} "
          f"iterations each on average (plain version's early stop, check_every=1)")

    for _ in range(3):
        pusch.pusch_rx(cfg, rx, n_iters=N_ITERS)
    ms = _time_ms(lambda: pusch.pusch_rx(cfg, rx, n_iters=N_ITERS), N_TIMED)
    print(f"main path: {B * 1000.0 / ms:.1f} slots/s ({ms:.3f} ms per {B}-slot batch, "
          f"{N_TIMED} batches, CUDA events) on {card}")
    return {"launches": launches, "errs": errs, "times": times, "bounds": bounds}


def phase_decoder(dev, gen) -> dict:
    """The decoder's entry point decode() in every variant, at both sizes
    and check_every 0 and 1, against its plain version and the sent bits;
    launch counts; then times at BG1 Z=384 x 208."""
    for k in ldpc_decoder.launches:
        ldpc_decoder.launches[k] = 0
    cases = [_awgn_code_blocks(bg, Z, n_cb, dev, gen) for bg, Z, n_cb in DECODER_SIZES]
    errs, iters = {}, {}                # (label, check_every) -> at BG1 Z=384 x 208
    for i, (g, info, llr) in enumerate(cases):
        for label, name, schedule, msg_dtype, in_dtype in VARIANTS:
            x = llr.to(in_dtype).contiguous()
            for ce in (0, 1):
                kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=ce)
                bk, okk = ldpc_decoder.decode(g, x, N_ITERS, **kw)
                torch.cuda.synchronize()
                bp, okp, it = ldpc_decoder.decode_plain(g, x, N_ITERS, return_iters=True, **kw)
                tag = f"{label} BG{g.bg} Z={g.Z} x{x.shape[0]} check_every={ce}"
                if not torch.equal(bk, bp):
                    raise AssertionError(f"{tag}: kernel bits differ from plain in "
                                         f"{int((bk != bp).sum())} places")
                if not torch.equal(bk, info):
                    raise AssertionError(f"{tag}: bits differ from sent")
                if not (torch.equal(okk, okp) and bool(okk.all())):
                    raise AssertionError(f"{tag}: ok flags differ or fail "
                                         f"({int(okk.sum())}/{okk.numel()} kernel)")
                if i == 0:
                    errs[label, ce] = int((bk.int() - bp.int()).abs().max())
                    iters[label, ce] = it
        print(f"BG{g.bg} Z={g.Z} x{llr.shape[0]}: every variant at check_every 0 and 1: "
              f"kernel == plain == sent, all parity ok")
    launches = {name: ldpc_decoder.launches[name] for name in ldpc_decoder.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"decoder path missed a kernel: launches {launches}")
    print(f"decoder variants: launches {launches}")

    g, _, llr = cases[0]
    rows = {}
    for label, name, schedule, msg_dtype, in_dtype in VARIANTS:
        x = llr.to(in_dtype).contiguous()
        row = {}
        for ce in (0, 1):
            kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=ce)
            ms = _time_ms(lambda: ldpc_decoder.decode(g, x, N_ITERS, **kw), 10)
            plain_ms = _time_ms(lambda: ldpc_decoder.decode_plain(g, x, N_ITERS, **kw), 2)
            it = iters[label, ce]
            bound, by = _decoder_bound(g, ldpc_decoder.prepare_input(x, msg_dtype), it,
                                       0 if name == "layered_bf16" else ce)   # K2: no checks
            row[ce] = {"ms": ms, "plain_ms": plain_ms, "bound": (bound, by),
                       "err": errs[label, ce], "mean_iters": float(it.float().mean())}
            print(f"{label} BG{g.bg} Z={g.Z} x{x.shape[0]} check_every={ce}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}), "
                  f"{row[ce]['mean_iters']:.3f} iterations per code block")
        rows.setdefault(name, row)           # first row of a kernel: f32 input
    return {"launches": launches, "rows": rows}


def phase_probes(dev, gen) -> dict:
    """Slice 2 launch probes T1/T2 against their plain version and x * 2."""
    for k in tiny.launches:
        tiny.launches[k] = 0
    out = {}
    for name, fn, shape in (("tiny", tiny.tiny, (8, 128)),
                            ("tiny_grid", tiny.tiny_grid, (8, 8, 128))):
        x = torch.randn(shape, generator=gen, device=dev)
        got = fn(x)
        torch.cuda.synchronize()
        err = float((got - tiny.tiny_plain(x)).abs().max())
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from x * 2 by {err}")
        out[name] = {"err": err, "x": x, "fn": fn}
    launches = dict(tiny.launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"launch probes missed a kernel: launches {launches}")
    for name, r in out.items():
        x, fn = r["x"], r["fn"]
        r["ms"] = _time_ms(lambda: fn(x), 200)
        r["plain_ms"] = _time_ms(lambda: tiny.tiny_plain(x), 200)
        r["library_ms"] = _time_ms(lambda: torch.mul(x, 2), 200)
        r["bound"] = _bound(2 * x.numel() * 4, x.numel())
        print(f"{name} {tuple(x.shape)}: kernel == x * 2; kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, torch.mul {r['library_ms']:.5f} ms (launch cost)")
    return {"launches": launches, "probes": out}


def _entry(name, launches, err, ms, plain_ms, bound, library_ms=None, **extra):
    src, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms, **extra}


def main() -> None:
    smi_line = phase_device()
    torch.manual_seed(SEED)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    phase_build()
    phase_frontend(dev, gen)
    main_path = phase_main_path(dev, gen, smi_line)
    decoder = phase_decoder(dev, gen)
    probes = phase_probes(dev, gen)

    kernels = []
    for name in ("layered_f32", "pusch_frontend"):   # slice 1: the main path's own
        ms, plain_ms = main_path["times"][name]
        kernels.append(_entry(name, main_path["launches"][name], main_path["errs"][name],
                              ms, plain_ms, main_path["bounds"][name]))
    for name, row in decoder["rows"].items():
        if name == "layered_f32":
            continue
        r1, r0 = row[1], row[0]
        kernels.append(_entry(name, decoder["launches"][name], r1["err"], r1["ms"],
                              r1["plain_ms"], r1["bound"], mean_iters=r1["mean_iters"],
                              max_abs_err_check_every_0=r0["err"],
                              ms_check_every_0=r0["ms"],
                              plain_ms_check_every_0=r0["plain_ms"],
                              bound_ms_check_every_0=r0["bound"][0]))
    for name, r in probes["probes"].items():
        kernels.append(_entry(name, probes["launches"][name], r["err"], r["ms"],
                              r["plain_ms"], r["bound"], r["library_ms"]))
    print(f"card: {smi_line}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
