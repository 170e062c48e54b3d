"""LDPC rate matching / recovery + HARQ combining, TS 38.212 §5.4.2.

Port of openairinterface5g_tpu/coding/rate_matching.py.  The circular-buffer
bit selection per (bg, Z, rv, E, F, Ncb) is a host table; it is piecewise
contiguous, so TX selection and RX recovery are run-wise slices
(``_rx_runs``) over all code blocks of equal E at once (``_cb_groups``).
Recovery into a persistent buffer is HARQ soft combining.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# TS 38.212 Table 5.4.2.1-2: k0 numerators per (bg, rv); k0 = floor(num * Ncb / (den*Z)) * Z
_K0_NUM = {1: {0: 0, 1: 17, 2: 33, 3: 56}, 2: {0: 0, 1: 13, 2: 25, 3: 43}}
_DEN = {1: 66, 2: 50}


def k0_offset(bg: int, Z: int, rv: int, Ncb: int) -> int:
    return (_K0_NUM[bg][rv] * Ncb // (_DEN[bg] * Z)) * Z


@functools.lru_cache(maxsize=256)
def selection_indices(bg: int, Z: int, kc: int, rv: int, E: int, F: int,
                      Ncb: int | None = None) -> np.ndarray:
    """(E,) int32 indices into the length-Ncb circular buffer d_0..d_{Ncb-1}.

    d is the mother codeword minus the first 2Z punctured systematic bits.
    Filler positions (K' - 2Z .. K - 2Z - 1) are skipped per spec.
    """
    K = kc * Z
    N = Ncb if Ncb is not None else _DEN[bg] * Z
    k0 = k0_offset(bg, Z, rv, N)
    is_filler = np.zeros(N, dtype=bool)
    is_filler[K - 2 * Z - F: K - 2 * Z] = True
    order = (k0 + np.arange(N)) % N
    usable = order[~is_filler[order]]
    reps = -(-E // len(usable))
    return np.tile(usable, reps)[:E].astype(np.int32)


@functools.lru_cache(maxsize=256)
def _rx_runs(bg: int, Z: int, kc: int, rv: int, E: int, F: int,
             ncb: int | None = None) -> tuple:
    """Contiguous runs (e_start, d_start, length) of the bit-selection map.

    Breaks occur only at the filler window, the buffer wrap and repetition
    restarts, so a handful of dense slices replace an E-element gather.
    """
    sel = selection_indices(bg, Z, kc, rv, E, F, ncb)
    brk = np.nonzero(np.diff(sel) != 1)[0] + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [E]])
    return tuple((int(s), int(sel[s]), int(e - s)) for s, e in zip(starts, ends))


@functools.lru_cache(maxsize=64)
def fused_rx_indices(bg: int, Z: int, kc: int, rv: int, es: tuple, qm: int,
                     F: int, ncb: int | None = None) -> np.ndarray:
    """One (G,) int32 host table fusing each code block's deinterleave and
    rate-match scatter: codeword position g -> flat index into the (C*N,)
    LLR buffer of the C code blocks.  Position i*Qm + j of a block's f holds
    e[j*(E/Qm) + i] (the deinterleave), which sits at d-index sel[e-index]."""
    N = _DEN[bg] * Z
    parts = []
    for j, E in enumerate(es):
        sel = selection_indices(bg, Z, kc, rv, E, F, ncb)          # (E,) into N
        f_pos = np.arange(E)
        parts.append(j * N + sel[(f_pos % qm) * (E // qm) + f_pos // qm])
    return np.concatenate(parts).astype(np.int32)


@functools.lru_cache(maxsize=64)
def fused_rx_gather_layers(bg: int, Z: int, kc: int, rv: int, es: tuple,
                           qm: int, F: int, ncb: int | None = None) -> np.ndarray:
    """Inverse of fused_rx_indices as gather layers: (L, C*N) int32 codeword
    positions, G (one past the last) where a buffer entry has no source in
    that layer; L is the largest repetition count (1 unless E exceeds the
    usable Ncb).  Layer r of entry t holds the r-th codeword position, in
    order, that lands on t."""
    N = _DEN[bg] * Z
    idx = fused_rx_indices(bg, Z, kc, rv, es, qm, F, ncb)
    CN, G = len(es) * N, len(idx)
    order = np.argsort(idx, kind="stable")
    sorted_t = idx[order]
    counts = np.bincount(idx, minlength=CN)
    rank = np.arange(G) - (np.cumsum(counts) - counts)[sorted_t]
    layers = np.full((max(1, int(counts.max())), CN), G, dtype=np.int32)
    layers[rank, sorted_t] = order
    return layers


def _cb_groups(es: tuple) -> list:
    """Contiguous groups (j0, j1, E) of identical per-CB rate-matched size."""
    groups = []
    j0 = 0
    for j in range(1, len(es) + 1):
        if j == len(es) or es[j] != es[j0]:
            groups.append((j0, j, es[j0]))
            j0 = j
    return groups


def interleave_tx(bits_e: torch.Tensor, Qm: int) -> torch.Tensor:
    """Bit interleaver, TS 38.212 §5.4.2.2: f_{i+j*Qm} = e_{i*(E/Qm)+j}."""
    E = bits_e.shape[-1]
    lead = bits_e.shape[:-1]
    return bits_e.reshape(*lead, Qm, E // Qm).transpose(-1, -2).reshape(*lead, E)


def deinterleave_rx(llr_f: torch.Tensor, Qm: int) -> torch.Tensor:
    """Inverse of interleave_tx (operates on LLRs at RX)."""
    E = llr_f.shape[-1]
    lead = llr_f.shape[:-1]
    return llr_f.reshape(*lead, E // Qm, Qm).transpose(-1, -2).reshape(*lead, E)


def fused_rate_match_rx(graph, llr_cw, rv: int, es: tuple, qm: int, F: int,
                        harq_buffer=None, filler_llr: float = 1e4,
                        ncb: int | None = None):
    """(B, G) codeword LLRs -> (B, C, cols*Z) mother-code LLRs.

    Per-CB deinterleave fused with run-wise circular-buffer recovery; CBs
    of equal E are one (B, Cg, E) tensor.  harq_buffer: optional
    (B, C, cols*Z) previous-round buffer to combine.
    """
    B = llr_cw.shape[0]
    offs = np.concatenate([[0], np.cumsum(es)])

    def seg_of_group(j0, j1, E):
        seg = llr_cw[:, offs[j0]: offs[j1]].reshape(B, j1 - j0, E)
        return deinterleave_rx(seg, qm)

    return _fused_rx_body(graph, seg_of_group, B, llr_cw.dtype, llr_cw.device,
                          es, rv, F, harq_buffer, filler_llr, ncb)


def fused_rate_match_rx_planes(graph, planes, rv: int, es: tuple, qm: int,
                               F: int, harq_buffer=None,
                               filler_llr: float = 1e4,
                               ncb: int | None = None):
    """Bit-plane LLRs (B, qm, G//qm) -> (B, C, cols*Z) mother-code LLRs.

    Plane j holds the e-domain positions of bit j (38.212 §5.4.2.2 groups
    the de-interleaved stream by bit index), flat = re*L + l.  Every per-CB
    E is a multiple of L*qm, so each CB's stream is a contiguous slice of
    each plane.
    """
    B = planes.shape[0]
    offs = np.concatenate([[0], np.cumsum(es)])

    def seg_of_group(j0, j1, E):
        a, b = offs[j0] // qm, offs[j1] // qm
        seg = planes[:, :, a:b].reshape(B, qm, j1 - j0, E // qm)
        return seg.permute(0, 2, 1, 3).reshape(B, j1 - j0, E)

    return _fused_rx_body(graph, seg_of_group, B, planes.dtype, planes.device,
                          es, rv, F, harq_buffer, filler_llr, ncb)


def _fused_rx_body(graph, seg_of_group, B, dtype, device, es, rv, F,
                   harq_buffer, filler_llr, ncb):
    g = graph
    C = len(es)
    N = g.N
    groups = _cb_groups(tuple(es))
    group_runs = [_rx_runs(g.bg, g.Z, g.kc, rv, E, F, ncb) for (_, _, E) in groups]
    # when every group's runs land at increasing, non-overlapping positions
    # (always at rv=0, and whenever E fits the buffer without wrap) the
    # recovery is one concatenation; otherwise runs are added in order
    concat_ok = all(
        all(runs[i][1] + runs[i][2] <= runs[i + 1][1] for i in range(len(runs) - 1))
        for runs in group_runs)
    if concat_ok:
        d_groups = []
        for (j0, j1, E), runs in zip(groups, group_runs):
            seg = seg_of_group(j0, j1, E)
            pieces, pos = [], 0
            for (e0, d0, ln) in runs:
                if d0 > pos:
                    pieces.append(torch.zeros((B, j1 - j0, d0 - pos), dtype=dtype, device=device))
                pieces.append(seg[:, :, e0: e0 + ln])
                pos = d0 + ln
            if pos < N:
                pieces.append(torch.zeros((B, j1 - j0, N - pos), dtype=dtype, device=device))
            d_groups.append(torch.cat(pieces, dim=-1))
        d = torch.cat(d_groups, dim=1)
    else:
        d = torch.zeros((B, C, N), dtype=dtype, device=device)
        for (j0, j1, E), runs in zip(groups, group_runs):
            seg = seg_of_group(j0, j1, E)
            for (e0, d0, ln) in runs:
                d[:, j0:j1, d0: d0 + ln] += seg[:, :, e0: e0 + ln]
    if F:
        filler = torch.zeros((N,), dtype=dtype, device=device)
        filler[g.K - 2 * g.Z - F: g.K - 2 * g.Z] = filler_llr
        d = d + filler
    full = torch.cat([torch.zeros((B, C, 2 * g.Z), dtype=dtype, device=device), d], dim=-1)
    if harq_buffer is not None:
        full = full + harq_buffer
    return full


def tx_cols_needed(graph, rv: int, es: tuple, F: int,
                   ncb: int | None = None) -> int:
    """Mother-code columns the TX bit selection reads, incl. the 2Z
    punctured head (lets ldpc.encode skip unused extension rows)."""
    g = graph
    max_end = max(d0 + ln
                  for (_, _, E) in _cb_groups(tuple(es))
                  for (_, d0, ln) in _rx_runs(g.bg, g.Z, g.kc, rv, E, F, ncb))
    return 2 + -(-max_end // g.Z)


def rate_match_tx(graph, codeword: torch.Tensor, rv: int, E: int, F: int,
                  ncb: int | None = None) -> torch.Tensor:
    """(..., cols*Z) mother codewords -> (..., E) transmitted bits of one
    code block each (the selection, without the interleaver).

    ncb: optional limited circular-buffer size (LBRM, TS 38.212 5.4.2.1).
    """
    g = graph
    d = codeword[..., 2 * g.Z:]                         # drop punctured head
    return torch.cat([d[..., d0: d0 + ln]
                      for (_, d0, ln) in _rx_runs(g.bg, g.Z, g.kc, rv, E, F, ncb)], dim=-1)


def rate_match_rx(graph, llr_e: torch.Tensor, rv: int, F: int, harq_buffer=None,
                  filler_llr: float = 1e4) -> torch.Tensor:
    """(B, E) received LLRs of one code block each -> (B, cols*Z)
    mother-code LLRs.

    Adds into `harq_buffer` (same shape, previous rounds' LLRs) when given:
    the HARQ soft combine.  Punctured head bits get LLR 0, fillers a large
    known-zero LLR.
    """
    full = _fused_rx_body(graph, lambda j0, j1, E: llr_e[:, None], llr_e.shape[0],
                          llr_e.dtype, llr_e.device, (llr_e.shape[-1],), rv, F,
                          None, filler_llr, None)[:, 0]
    return full if harq_buffer is None else full + harq_buffer


def fused_rate_match_tx(graph, codeword_cbs, rv: int, es: tuple, qm: int,
                        F: int, ncb: int | None = None):
    """(B, C, cols*Z) mother codewords -> (B, G) interleaved codeword bits."""
    B = codeword_cbs.shape[0]
    parts = []
    for (j0, j1, E) in _cb_groups(tuple(es)):
        seg = rate_match_tx(graph, codeword_cbs[:, j0:j1], rv, E, F, ncb)   # (B, Cg, E)
        parts.append(interleave_tx(seg, qm).reshape(B, -1))
    return torch.cat(parts, dim=-1)

