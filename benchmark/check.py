"""What decides ``correct``: the program's outputs of the window, held
against the bits that were drawn and against the plain reference
(``nr.receive``) run on the same received samples.

Numbers compared, each against its limit:

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

from . import nr

BLOCK = 8          # slots the reference takes at once


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


def passed(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())
