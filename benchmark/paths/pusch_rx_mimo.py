"""The gNB's uplink receiver at 1 to 4 layers on both CDM groups:
``models/pusch.py::pusch_rx`` over a call's slots, the path of a
configuration file with ``"path": "pusch_rx_mimo"``.

The step, the program's configuration, the channel and the check are
``paths/pusch_rx.py``'s; what differs is the plain reference, which here is
``benchmark/nr_mimo.py`` (``nr.py`` stops at 2 layers on CDM group 0).  The
pool: per call, the slots' transport blocks drawn on the device, sent by
``nr_mimo.transmit`` through ``pusch_rx.channel_matrix`` and the traffic's
noise.  ``correct`` is ``pusch_rx.judge``'s, with its numbers and limits
(``llr_gap``, ``tb_bits_wrong``, ``tb_crc_failed``, ``cb_parity_failed``,
``cb_flags_differ``), given ``nr_mimo``'s results for every pool entry it
reads, so that it never falls back on the 2-layer reference.

Where K3 does not take the configuration (more than 2 layers), the
program runs ``pusch_frontend``'s eager chain: the estimate, the detector
and the LLRs get spans of their own (``layer_spans``), and the detector's
work is counted here (``equalize_work``).
"""
from __future__ import annotations

import contextlib

import torch

from benchmark import nr, nr_mimo, tracing, workcount
from benchmark.paths import pusch_rx

BLOCK = pusch_rx.BLOCK
Steps, steps, program_config = pusch_rx.Steps, pusch_rx.steps, pusch_rx.program_config
# the eager frontend's spans, each around the program's function of that stage
EAGER_SPANS = (("pusch_channel_estimate", "phy/channel_estimation.py"),
               ("pusch_equalize", "phy/equalization.py"),
               ("pusch_llrs", "phy/llr.py"))


def reference_config(config: dict) -> nr.Pusch:
    return nr_mimo.pusch(config)


def make_pool(p: nr.Pusch, traffic: dict, seed: int, device: torch.device):
    """(pool of (slots, n_rx, samples) complex64 calls, their (slots, A)
    transport blocks), made on the device in one pass per call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B, ch = traffic["slots_per_call"], traffic["channel"]
    h = pusch_rx.channel_matrix(p.n_rx, p.n_layers, ch["cross"]).to(
        device=device, dtype=torch.complex64)
    pool, blocks = [], []
    for _ in range(traffic["pool_calls"]):
        tb = torch.randint(0, 2, (B, p.A), generator=gen, device=device, dtype=torch.int8)
        rx = torch.einsum("rl,bls->brs", h, nr_mimo.transmit(p, tb))
        noise = torch.randn((2, *rx.shape), generator=gen, device=device)
        pool.append((rx + ch["noise_std"] * torch.complex(noise[0], noise[1])).contiguous())
        blocks.append(tb)
    return pool, blocks


def reference(p: nr.Pusch, rx: torch.Tensor, q: nr.Quantize = nr.exact) -> dict:
    """nr_mimo.receive over a call's slots, BLOCK at a time."""
    parts = [nr_mimo.receive(p, rx[i: i + BLOCK], q) for i in range(0, rx.shape[0], BLOCK)]
    return {k: torch.cat([d[k] for d in parts]) for k in parts[0]}


def verdict(run, steps: Steps, pool: list, blocks: list, sampled: list, limits: dict) -> tuple:
    """pusch_rx.judge's numbers over the window, given the reference of
    every pool entry a traced or a sampled call read; the traced ones'
    iterations a code block go to run.iters for the decode's roofline."""
    traced = set(run.traced_calls)
    refs = {j: reference(run.p, pool[j])
            for j in sorted(traced | {k % len(pool) for k in sampled})}
    for j in traced:
        run.iters[j] = refs[j]["iters"].reshape(-1).tolist()
    return pusch_rx.judge(run.p, sampled, steps.kept, pool, blocks, steps.tb_ok, steps.cb_ok,
                          limits, refs)


def control(cell, seed: int, device) -> dict:
    """The control's numbers for one seed: nr_mimo's receiver in the
    program's place, its frontend rounded to bfloat16 at every stage
    (``nr.bf16``), judged by the same check on the same sampled calls."""
    from benchmark import harness, load
    p = reference_config(cell.config)
    pool, blocks = make_pool(p, cell.traffic, seed, device)
    sampled = load.sampled_calls(seed, len(pool), harness.SAMPLED)
    kept = {k: reference(p, pool[k % len(pool)], nr.bf16) for k in sampled}
    refs = {k % len(pool): reference(p, pool[k % len(pool)]) for k in sampled}
    numbers, _, failed = pusch_rx.judge(p, sampled, kept, pool, blocks,
                                        [o["tb_ok"] for o in kept.values()],
                                        [o["cb_ok"] for o in kept.values()],
                                        cell.config["check"], refs)
    return {k: v for k, (v, _) in numbers.items()} | {"failed": failed}


@contextlib.contextmanager
def layer_spans():
    """pusch_rx's layer spans, and around the eager frontend's stages and
    the codeword-order rate recovery their own, while the context is held;
    the functions are put back after it."""
    from openairinterface5g_tpu_torch.coding import rate_matching
    from openairinterface5g_tpu_torch.models import pusch

    eager = [(pusch, fn, tracing.wrap(getattr(pusch, fn), span)) for fn, span in EAGER_SPANS]
    with pusch_rx.layer_spans(), tracing.patched(eager + [
            (rate_matching, "fused_rate_match_rx",
             tracing.wrap(rate_matching.fused_rate_match_rx, "coding/rate_recovery"))]):
        yield


def equalize_work(slots: int, n_layers: int, n_rx: int, n_data: int, n_sc: int) -> tuple:
    """(bytes, float32 operations) of the MMSE detector over `slots` slots,
    the least whatever implements it.  Bytes, each once: the data REs'
    samples y (R S M complex64) and the estimate h (R L M complex64) read,
    the compensated symbols x (L S M complex64) and their gains (L S M
    float32) written.  Operations, 8 a complex multiply-add: per subcarrier
    H^H H (L^2 R), one factorisation of A (L^3) and diag(A^-1 G) (L^3); per
    data RE H^H y (L R) and its product with A^-1 (L^2)."""
    L, R, S, M = n_layers, n_rx, n_data, n_sc
    n_bytes = slots * (R * S * M * 8 + R * L * M * 8 + L * S * M * 8 + L * S * M * 4)
    n_ops = slots * 8 * (M * (L * L * R + 2 * L ** 3) + S * M * (L * R + L * L))
    return n_bytes, n_ops


def work_of(run, layer: str) -> tuple:
    """(least seconds, bound) of the work a layer did over the traced calls:
    ``decode`` (K1, as pusch_rx counts it) or ``equalize`` (the MMSE)."""
    if layer != "equalize":
        return pusch_rx.work_of(run, layer)
    p = run.p
    n_bytes, n_ops = equalize_work(len(run.traced_calls) * run.slots_per_call, p.n_layers,
                                   p.n_rx, len(p.data_symbols), p.n_sc)
    return workcount.least_s(n_bytes, n_ops)
