"""The gNB's downlink transmitter: ``models/pdsch.py::pdsch_tx`` over a
call's slots, the path of a configuration file with ``"path": "pdsch_tx"``.

The pool: per call, the slots' transport blocks, drawn on the device from
the seed in one call.  The step hands back to the host what a split-8 gNB
hands to its radio: the slots' waveforms, (slots, antennas, samples)
complex64; the sampled calls' scrambled codeword bits too stay on the
device.

What decides ``correct``: the sampled calls' outputs held against the plain
reference's transmitter (``nr.codeword_bits``, ``nr.slot_grid``,
``nr.ofdm_modulate``) on the same transport blocks, BLOCK slots at a
time.  Numbers compared, each against its limit:

- ``wave_gap``: over the sampled calls' slots (infinite where a sampled
  call never came back), the largest max|program - reference| /
  max|reference| of a slot's samples.  The waveform is the path's only
  float output, so a lower precision shows here; the limit is the
  configuration's ``check.wave_gap``.
- ``cw_bits_wrong``: sampled slots whose scrambled codeword bits differ
  from the reference's (limit 0).

Every slot of the window is attempted; a sampled slot that fails either
number is failed.
"""
from __future__ import annotations

import math

import torch

from benchmark import nr, tracing, workcount

BLOCK = 8          # slots the reference takes at once
# fields of the configuration file that PdschConfig takes as they are
PROGRAM_FIELDS = ("mu", "n_prb", "mcs", "mcs_table", "n_layers", "n_symbols", "rnti",
                  "n_id", "slot")


def reference_config(config: dict) -> nr.Pusch:
    if config["rv"] != 0:
        raise ValueError("the reference transmits redundancy version 0")
    return nr.Pusch.from_config(config)


def program_config(config: dict):
    from openairinterface5g_tpu_torch.models.pdsch import PdschConfig
    kw = {k: config[k] for k in PROGRAM_FIELDS}
    return PdschConfig(dmrs_symbols=tuple(config["dmrs_symbols"]), **kw)


class Steps:
    """The executor's step and what the window keeps of it."""

    def __init__(self, cfg, rv: int, sampled: list):
        from openairinterface5g_tpu_torch.models import pdsch
        self.pdsch, self.cfg, self.rv = pdsch, cfg, rv
        self.sampled = set(sampled)
        self.counting = False
        self.n = 0              # calls of the window so far
        self.kept: dict = {}

    def __call__(self, i: int, tb: torch.Tensor) -> dict:
        wave, bits = self.pdsch.pdsch_tx(self.cfg, tb, rv=self.rv)
        if self.counting:
            if self.n in self.sampled:
                self.kept[self.n] = {"waveform": wave, "cw_bits": bits}
            self.n += 1
        return {"waveform": wave}


def steps(cfg, config: dict, sampled: list) -> Steps:
    return Steps(cfg, config["rv"], sampled)


def make_pool(p: nr.Pusch, traffic: dict, seed: int, device: torch.device):
    """(pool of (slots, A) int8 transport blocks, one a call; the same list
    as what the check needs), drawn on the device in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (traffic["pool_calls"], traffic["slots_per_call"], p.A)
    pool = list(torch.randint(0, 2, shape, generator=gen, device=device,
                              dtype=torch.int8).unbind(0))
    return pool, pool


def reference(p: nr.Pusch, tb: torch.Tensor, q: nr.Quantize = nr.exact) -> dict:
    """The plain transmitter over a call's slots, BLOCK at a time: the
    waveform (its RE grid rounded by q before the IFFT) and the scrambled
    codeword bits."""
    waves, bits = [], []
    for i in range(0, tb.shape[0], BLOCK):
        b = nr.codeword_bits(p, tb[i: i + BLOCK])
        waves.append(nr.ofdm_modulate(p, q(nr.slot_grid(p, b))))
        bits.append(b)
    return {"waveform": torch.cat(waves), "cw_bits": torch.cat(bits)}


def wave_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(slots,) max|got - ref| / max|ref| of each slot; infinite where the
    shapes differ or got is not finite."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return torch.full((ref.shape[0],), float("inf"))
    d = (got - ref).abs().flatten(1).amax(1) / ref.abs().flatten(1).amax(1)
    return d.cpu()


def judge(p: nr.Pusch, sampled: list, kept: dict, blocks: list, limits: dict,
          calls: int) -> tuple:
    """(numbers {name: (value, limit)}, attempted slots, failed slots).

    sampled: the call indices whose outputs the window was to keep; kept:
    call index -> that call's outputs (waveform, cw_bits); call k sent
    blocks[k % len(blocks)]; calls: the window's calls."""
    slots = blocks[0].shape[0]
    gap, wrong, failed = 0.0, 0, 0
    for k in sampled:
        if k not in kept:
            gap, failed = float("inf"), failed + slots
            continue
        out, ref = kept[k], reference(p, blocks[k % len(blocks)])
        gaps = wave_gaps(out["waveform"], ref["waveform"])
        if out["cw_bits"].shape == ref["cw_bits"].shape:
            bad_bits = (out["cw_bits"] != ref["cw_bits"]).any(dim=1).cpu()
        else:
            bad_bits = torch.ones(slots, dtype=torch.bool)
        gap = max(gap, float(gaps.max()))
        wrong += int(bad_bits.sum())
        failed += int((bad_bits | (gaps > limits["wave_gap"])).sum())
    numbers = {"wave_gap": (gap, limits["wave_gap"]), "cw_bits_wrong": (wrong, 0)}
    return numbers, calls * slots, failed


def verdict(run, steps: Steps, pool: list, blocks: list, sampled: list, limits: dict) -> tuple:
    return judge(run.p, sampled, steps.kept, blocks, limits, steps.n)


def control(cell, seed: int, device) -> dict:
    """The control's numbers for one seed: the plain reference in the
    program's place, its RE grid rounded to bfloat16 before the IFFT
    (``nr.bf16``), judged by the same check on the same sampled calls."""
    from benchmark import harness, load
    p = reference_config(cell.config)
    pool, blocks = make_pool(p, cell.traffic, seed, device)
    sampled = load.sampled_calls(seed, len(pool), harness.SAMPLED)
    kept = {k: reference(p, pool[k % len(pool)], nr.bf16) for k in sampled}
    numbers, _, failed = judge(p, sampled, kept, blocks, cell.config["check"], len(sampled))
    return {k: v for k, (v, _) in numbers.items()} | {"failed": failed}


def layer_spans():
    """Spans named after the layers of pdsch_tx's path, opened around the
    program's own functions while the context is held: pusch_tx (which
    pdsch_tx is) as models/pusch.py, whose own ops are the CRCs,
    segmentation, rate matching, scrambling, QAM, layer and RE mapping and
    the DMRS; ldpc.encode as coding/encode; map_to_grid and ofdm_modulate
    as phy/ofdm.py; the executor's to_host."""
    from openairinterface5g_tpu_torch.coding import ldpc
    from openairinterface5g_tpu_torch.models import pdsch, pusch
    from openairinterface5g_tpu_torch.runtime import executor

    return tracing.patched([
        (pdsch, "pusch_tx", tracing.wrap(pdsch.pusch_tx, "models/pusch.py")),
        (ldpc, "encode", tracing.wrap(ldpc.encode, "coding/encode")),
        (pusch, "map_to_grid", tracing.wrap(pusch.map_to_grid, "phy/ofdm.py")),
        (pusch, "ofdm_modulate", tracing.wrap(pusch.ofdm_modulate, "phy/ofdm.py")),
        (executor, "to_host", tracing.wrap(executor.to_host, "runtime/executor.py")),
    ])


def encoder_columns(p: nr.Pusch) -> int:
    """Mother-code columns the rate matching of rv 0 reads, from the
    configuration: the punctured 2 Z, the largest E and the fillers."""
    s = p.seg
    return min(nr.graph(s.bg, s.Z).cols, math.ceil((max(p.es) + 2 * s.Z + s.F) / s.Z))


def work_of(run, layer: str) -> tuple:
    """(least seconds, bound) of the work a layer did over the traced calls:
    ``encode`` (the LDPC encoder)."""
    p = run.p
    s = p.seg
    g = nr.graph(s.bg, s.Z)
    n_cb = len(run.traced_calls) * run.slots_per_call * s.C
    n_bytes, n_ops = workcount.encoder_work(s.Z, g.kc, (g.tab >= 0).sum(1).tolist(),
                                            encoder_columns(p), n_cb)
    return workcount.least_s(n_bytes, n_ops, workcount.INT32_OPS_PER_S)
