"""The work of the path's kernels, counted from shapes, and the card's peaks.

A roofline share is the least time the card could take for the work, over
the time the work took on the device.  The least time is the larger of the
bytes over the published HBM bandwidth and the operations over the
published float32 rate outside the tensor cores (NVIDIA H100 SXM data
sheet, dense, at 700 W).  Both counts are of the function computed, not of
the kernel that computes it, so two versions of a kernel share one bound.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# min-sum operations per edge, lane and iteration: v = t - o, |v|, three
# for min1/min2, sign xor, the excluded-min compare and select, the sign
# select, the two of the total update; per row, lane and iteration: the
# scale of min1 and of min2; per edge and lane of a syndrome check: load
# compare and xor
OPS_PER_EDGE_ITER = 11
OPS_PER_ROW_ITER = 2
OPS_PER_EDGE_CHECK = 2


def least_s(n_bytes: float, n_ops: float) -> tuple:
    """(least seconds on the card, "bytes" or "operations": what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decoder_work(Z: int, kc: int, rows: int, edges: int, cols: int, in_bytes: int,
                 iters: list, check_every: int) -> tuple:
    """(bytes, operations) of one layered min-sum decode of len(iters) code
    blocks: the input (cols Z values of in_bytes) read once, the info bits
    and the ok flag written once; the iterations each block ran, its checks
    (one every check_every iterations, and one more for the flag where the
    last iteration ran none)."""
    n_cb, it = len(iters), sum(iters)
    n_bytes = n_cb * (cols * Z * in_bytes + kc * Z + 1)
    if check_every:
        n_checks = sum(i // check_every + (i % check_every != 0) for i in iters)
    else:
        n_checks = n_cb
    n_ops = Z * (it * (OPS_PER_EDGE_ITER * edges + OPS_PER_ROW_ITER * rows)
                 + OPS_PER_EDGE_CHECK * edges * n_checks)
    return n_bytes, n_ops


def frontend_ops(slots: int, n_layers: int, n_rx: int, qm: int, n_dmrs: int, n_data: int,
                 window: int, n_prb: int) -> int:
    """Arithmetic operations of the frontend over `slots` slots: the
    estimate per antenna and pilot, then per data RE the detector, the
    LLRs and their descrambling.  A complex multiply is 6, a complex add 2,
    |z|^2 3, a divide, select or fabs 1; index arithmetic is not counted.

    Per pilot: LS and its sum per DMRS symbol (8; one layer: the
    adjacent-pilot noise term, 12 more) and the mean (2); two layers: the
    OCC split (8) and the pair-difference noise term on every second pilot
    (20); per port the replicate-padded window sum and mean (2w + 2); per
    port and subcarrier, the off-comb half interpolated (2 on average).
    Per data RE: per antenna the matched filter and gain of each layer
    (12), with two layers the cross term (8) too; the closed-form 2x2 MMSE
    (38); per layer the qm max-log LLRs and their descrambling selects."""
    P, R = n_layers, n_rx
    n_pil, M = 6 * n_prb, 12 * n_prb
    per_pilot = n_dmrs * (8 + (12 if P == 1 else 0)) + 2 + (18 if P == 2 else 0)
    per_pilot += P * (2 * window + 2) if window > 1 else 0
    est = R * (n_pil * per_pilot + P * M * 2)
    llr = {2: 2, 4: 5, 6: 10, 8: 15}[qm]
    per_re = R * (12 if P == 1 else 32) + (38 if P == 2 else 0) + P * (llr + qm)
    return slots * (est + n_data * M * per_re)


def frontend_bytes(slots: int, n_rx: int, n_sc: int, G: int) -> int:
    """The RE grid (complex64) read once, the f32 LLR planes written once."""
    return slots * (n_rx * 14 * n_sc * 8 + G * 4)
