"""The gNB's uplink receiver: ``models/pusch.py::pusch_rx`` over a call's
slots, the path of a configuration file without a ``path`` key.

The pool: per call, the slots' transport blocks drawn on the device, sent
by the plain reference's transmitter (``nr.transmit``) through the
traffic's ``channel``: ``cross`` (each receive antenna hears its layer,
repeated over the antennas, plus ``cross`` times the layer of the antenna
in mirror position) and ``noise_std`` (per real dimension of a sample).
The step hands back to the host what a MAC takes: ``tb_bits``, ``tb_ok``
and ``cb_ok``; the sampled calls' LLRs too stay on the device.

What decides ``correct``: the program's outputs of the window, held
against the bits that were drawn and against the plain reference
(``nr.receive``) run on the same received samples.  Numbers compared, each
against its limit:

- ``llr_gap``: over the sampled calls' slots (infinite where a sampled
  call never came back), the largest
  max|program LLR - reference LLR| / max|reference LLR| of a slot.  The
  frontend's LLRs are the path's only float output, so a lower precision
  shows here; the limit is the configuration's ``check.llr_gap``.
- ``tb_bits_wrong``: sampled slots whose decoded transport block differs
  from the one drawn (limit 0).
- ``tb_crc_failed``: slots of the whole window whose CRC failed (limit 0).
- ``cb_parity_failed``: code blocks of the whole window whose parity
  failed (limit 0).
- ``cb_flags_differ``: sampled code blocks whose parity flag differs from
  the reference decoder's (limit 0).
"""
from __future__ import annotations

import torch

from benchmark import nr, tracing, workcount

BLOCK = 8          # slots the reference takes at once
# fields of the configuration file that PuschConfig takes as they are
PROGRAM_FIELDS = ("mu", "n_prb", "mcs", "mcs_table", "n_layers", "n_rx", "n_symbols",
                  "rnti", "n_id", "slot", "chest_window", "decoder_backend",
                  "frontend_backend", "decoder_check_every")


def reference_config(config: dict) -> nr.Pusch:
    return nr.Pusch.from_config(config)


def program_config(config: dict):
    from openairinterface5g_tpu_torch.models.pusch import PuschConfig
    kw = {k: config[k] for k in PROGRAM_FIELDS}
    return PuschConfig(dmrs_symbols=tuple(config["dmrs_symbols"]), **kw)


class Steps:
    """The executor's step and what the window keeps of it."""

    def __init__(self, cfg, n_iters: int, sampled: list):
        from openairinterface5g_tpu_torch.models import pusch
        self.pusch, self.cfg, self.n_iters = pusch, cfg, n_iters
        self.sampled = set(sampled)
        self.counting = False
        self.n = 0              # calls of the window so far
        self.kept: dict = {}
        self.tb_ok: list = []
        self.cb_ok: list = []

    def __call__(self, i: int, rx: torch.Tensor) -> dict:
        out = self.pusch.pusch_rx(self.cfg, rx, n_iters=self.n_iters)
        res = {"tb_bits": out["tb_bits"], "tb_ok": out["tb_ok"], "cb_ok": out["cb_ok"]}
        if self.counting:
            self.tb_ok.append(out["tb_ok"])
            self.cb_ok.append(out["cb_ok"])
            if self.n in self.sampled:
                self.kept[self.n] = dict(res, llrs=out["llrs"])
            self.n += 1
        return res


def steps(cfg, config: dict, sampled: list) -> Steps:
    return Steps(cfg, config["n_iters"], sampled)


def channel_matrix(n_rx: int, n_layers: int, cross: float) -> torch.Tensor:
    """(n_rx, n_layers): antenna r hears layer r mod L, and `cross` times
    the layer that antenna n_rx - 1 - r hears."""
    e = torch.zeros((n_rx, n_layers))
    e[torch.arange(n_rx), torch.arange(n_rx) % n_layers] = 1.0
    return e + cross * e.flip(0)


def make_pool(p: nr.Pusch, traffic: dict, seed: int, device: torch.device):
    """(pool of (slots, n_rx, samples) complex64 calls, their (slots, A)
    transport blocks), made on the device in one pass per call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B, ch = traffic["slots_per_call"], traffic["channel"]
    h = channel_matrix(p.n_rx, p.n_layers, ch["cross"]).to(device=device, dtype=torch.complex64)
    pool, blocks = [], []
    for _ in range(traffic["pool_calls"]):
        tb = torch.randint(0, 2, (B, p.A), generator=gen, device=device, dtype=torch.int8)
        tx = nr.transmit(p, tb)                                        # (B, L, S)
        rx = torch.einsum("rl,bls->brs", h, tx)
        noise = torch.randn((2, *rx.shape), generator=gen, device=device)
        rx = rx + ch["noise_std"] * torch.complex(noise[0], noise[1])
        pool.append(rx.contiguous())
        blocks.append(tb)
    return pool, blocks


def reference(p: nr.Pusch, rx: torch.Tensor, q: nr.Quantize = nr.exact) -> dict:
    """nr.receive over a call's slots, BLOCK at a time."""
    parts = [nr.receive(p, rx[i: i + BLOCK], q) for i in range(0, rx.shape[0], BLOCK)]
    return {k: torch.cat([d[k] for d in parts]) for k in parts[0]}


def codeword_order(llrs: torch.Tensor) -> torch.Tensor:
    """The program's LLRs as (slots, G) in codeword order: bit planes
    (slots, qm, G / qm), plane j holding bit j of every (RE, layer), are
    interleaved back; (slots, G) is taken as it is."""
    if llrs.dim() == 3:
        return llrs.transpose(1, 2).reshape(llrs.shape[0], -1)
    return llrs


def llr_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = codeword_order(got).float()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    per_slot = (got - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
    return float(per_slot.max())


def judge(p: nr.Pusch, sampled: list, kept: dict, pool: list, blocks: list, tb_ok: list,
          cb_ok: list, limits: dict, refs: dict | None = None) -> tuple:
    """(numbers {name: (value, limit)}, attempted slots, failed slots).

    sampled: the call indices whose outputs the window was to keep; kept:
    call index -> that call's outputs (llrs, tb_bits, tb_ok, cb_ok); call k
    read pool[k % len(pool)], drawn from blocks[k % len(pool)]; tb_ok, cb_ok:
    every call's flags, in call order; refs: reference results by pool
    index, filled in here where missing."""
    refs = {} if refs is None else refs
    slots = pool[0].shape[0]
    ok_all = torch.cat([t.reshape(-1).cpu() for t in tb_ok]) if tb_ok else torch.ones(0, dtype=torch.bool)
    cb_all = torch.cat([t.reshape(-1).cpu() for t in cb_ok]) if cb_ok else torch.ones(0, dtype=torch.bool)
    bad = {(i // slots, i % slots) for i in (~ok_all).nonzero().reshape(-1).tolist()}
    gap, wrong, differ = 0.0, 0, 0
    for k in sampled:
        if k not in kept:
            gap = float("inf")
            continue
        out, j = kept[k], k % len(pool)
        if j not in refs:
            refs[j] = reference(p, pool[j])
        ref = refs[j]
        gap = max(gap, llr_gap(out["llrs"], ref["llrs"]))
        bits = out["tb_bits"]
        if bits.shape == blocks[j].shape:
            wrong_slots = (bits != blocks[j]).any(dim=1).cpu().nonzero().reshape(-1).tolist()
        else:
            wrong_slots = list(range(slots))
        wrong += len(wrong_slots)
        bad |= {(k, s) for s in wrong_slots}
        flags, ref_flags = out["cb_ok"].cpu(), ref["cb_ok"].cpu()
        differ += (int((flags != ref_flags).sum()) if flags.shape == ref_flags.shape
                   else ref_flags.numel())
    numbers = {
        "llr_gap": (gap, limits["llr_gap"]),
        "tb_bits_wrong": (wrong, 0),
        "tb_crc_failed": (int((~ok_all).sum()), 0),
        "cb_parity_failed": (int((~cb_all).sum()), 0),
        "cb_flags_differ": (differ, 0),
    }
    return numbers, int(ok_all.numel()), len(bad)


def verdict(run, steps: Steps, pool: list, blocks: list, sampled: list, limits: dict) -> tuple:
    """judge's numbers over the window; first the reference over each
    traced call, whose iterations a code block needs the decode's roofline
    reads (run.iters)."""
    refs: dict = {}
    for j in sorted(set(run.traced_calls)):
        refs[j] = reference(run.p, pool[j])
        run.iters[j] = refs[j]["iters"].reshape(-1).tolist()
    return judge(run.p, sampled, steps.kept, pool, blocks, steps.tb_ok, steps.cb_ok, limits, refs)


def control(cell, seed: int, device) -> dict:
    """The control's numbers for one seed: the plain reference in the
    program's place, its frontend rounded to bfloat16 at every stage
    (``nr.bf16``), judged by the same check on the same sampled calls."""
    from benchmark import harness, load
    p = reference_config(cell.config)
    pool, blocks = make_pool(p, cell.traffic, seed, device)
    sampled = load.sampled_calls(seed, len(pool), harness.SAMPLED)
    kept, refs = {}, {}
    for k in sampled:
        out = reference(p, pool[k % len(pool)], nr.bf16)
        kept[k] = {"llrs": out["llrs"], "tb_bits": out["tb_bits"], "tb_ok": out["tb_ok"],
                   "cb_ok": out["cb_ok"]}
    numbers, _, failed = judge(p, sampled, kept, pool, blocks,
                               [o["tb_ok"] for o in kept.values()],
                               [o["cb_ok"] for o in kept.values()],
                               cell.config["check"], refs)
    return {k: v for k, (v, _) in numbers.items()} | {"failed": failed}


def layer_spans():
    """Spans named after the layers of pusch_rx's path, opened around the
    program's own functions while the context is held; the functions are
    put back after it."""
    from openairinterface5g_tpu_torch.coding import rate_matching, segmentation
    from openairinterface5g_tpu_torch.models import pusch
    from openairinterface5g_tpu_torch.ops import pusch_frontend
    from openairinterface5g_tpu_torch.runtime import executor

    def decoder(name, _orig=pusch.ldpc_decoder):
        return tracing.wrap(_orig(name), "coding/decode")

    return tracing.patched([
        (pusch, "pusch_rx", tracing.wrap(pusch.pusch_rx, "models/pusch.py")),
        (pusch, "ofdm_demodulate", tracing.wrap(pusch.ofdm_demodulate, "phy/ofdm.py")),
        (pusch, "extract_from_grid", tracing.wrap(pusch.extract_from_grid, "phy/ofdm.py")),
        (pusch_frontend, "frontend_planes",
         tracing.wrap(pusch_frontend.frontend_planes, "ops/pusch_frontend.py")),
        (rate_matching, "fused_rate_match_rx_planes",
         tracing.wrap(rate_matching.fused_rate_match_rx_planes, "coding/rate_recovery")),
        (pusch, "ldpc_decoder", decoder),
        (segmentation, "desegment_tb", tracing.wrap(segmentation.desegment_tb, "coding/desegment")),
        (pusch, "crc_ok", tracing.wrap(pusch.crc_ok, "coding/crc")),
        (executor, "to_host", tracing.wrap(executor.to_host, "runtime/executor.py")),
    ])


def work_of(run, layer: str) -> tuple:
    """(least seconds, bound) of the work a layer did over the traced calls:
    ``decode`` (K1) or ``frontend`` (K3)."""
    p, B = run.p, run.slots_per_call
    if layer == "decode":
        g = nr.graph(p.seg.bg, p.seg.Z)
        iters = [i for j in run.traced_calls for i in run.iters[j]]
        n_bytes, n_ops = workcount.decoder_work(g.Z, g.kc, g.rows, g.edges, g.cols, 2,
                                                iters, p.check_every)
    else:
        n = len(run.traced_calls) * B
        n_bytes = workcount.frontend_bytes(n, p.n_rx, p.n_sc, p.G)
        n_ops = workcount.frontend_ops(n, p.n_layers, p.n_rx, p.qm, len(p.dmrs_symbols),
                                       len(p.data_symbols), p.chest_window, p.n_prb)
    return workcount.least_s(n_bytes, n_ops)
