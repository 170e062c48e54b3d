"""NR LDPC (TS 38.212 §5.3.2): lifted graph, encoder, flooding min-sum decoder.

Port of openairinterface5g_tpu/coding/ldpc.py.

* ``build_graph`` is host numpy: the lifted graph as (row, col, shift)
  tables, plus the double-diagonal core solve order of the encoder.
* ``encode`` is the roll/XOR chain: XOR of the four core rows isolates p0
  up to one cyclic shift, forward substitution gives p1..p3, and each
  extension row adds one identity-diagonal parity column.
* ``decode`` is flooding normalized min-sum, the port's ``"reference"``
  decoder and the oracle for the layered CUDA kernel
  (``ops/ldpc_decoder.py``).

Bits are in {0,1}; an LLR > 0 means bit 0.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..data.tables import BG_INFO_COLS, load_base_graph

_BIG = 1e30


@dataclasses.dataclass(frozen=True)
class LDPCGraph:
    """Static lifted-graph description for one (bg, Z)."""

    bg: int
    Z: int
    kc: int                      # info columns (22 / 10)
    rows: int                    # parity rows (46 / 42)
    cols: int                    # total columns (68 / 52)
    max_deg: int                 # max check-node degree
    tab: np.ndarray              # (rows, cols) shifts, -1 = no edge
    # decoder layout, (rows, max_deg) padded edge arrays
    ecol: np.ndarray             # int32 column id, pad = cols (dummy col)
    eshift: np.ndarray           # int32 shift, pad = 0
    evalid: np.ndarray           # bool
    # encoder: shift isolating p0 from the XOR of the four core rows
    p0_shift: int
    core_order: tuple            # ((row, col, vshift), ...) solve order for p1..p3

    @property
    def K(self) -> int:
        return self.kc * self.Z

    @property
    def N_full(self) -> int:
        """Full mother-code length incl. the 2Z punctured systematic cols."""
        return self.cols * self.Z

    @property
    def N(self) -> int:
        """Circular-buffer length (66Z / 50Z)."""
        return (self.cols - 2) * self.Z


def _cancel_pairs(shifts: Sequence[int]) -> list[int]:
    """Shifts left after removing equal pairs (x ^ x = 0 over GF(2))."""
    out: list[int] = []
    for s in shifts:
        if s in out:
            out.remove(s)
        else:
            out.append(s)
    return out


@functools.lru_cache(maxsize=64)
def build_graph(bg: int, Z: int) -> LDPCGraph:
    tab = load_base_graph(bg, Z)
    rows, cols = tab.shape
    kc = BG_INFO_COLS[bg]

    max_deg = int((tab >= 0).sum(axis=1).max())
    ecol = np.full((rows, max_deg), cols, dtype=np.int32)
    eshift = np.zeros((rows, max_deg), dtype=np.int32)
    evalid = np.zeros((rows, max_deg), dtype=bool)
    for r in range(rows):
        js = np.nonzero(tab[r] >= 0)[0]
        ecol[r, : len(js)] = js
        eshift[r, : len(js)] = tab[r, js]
        evalid[r, : len(js)] = True

    # encoder core: the four core rows' XOR must leave p0 under one shift,
    # and p1..p3 must cancel
    core = [int(tab[i, kc]) for i in range(4) if tab[i, kc] >= 0]
    surviving = _cancel_pairs(core)
    if len(surviving) != 1:
        raise AssertionError(f"BG{bg} Z={Z}: core column does not reduce to one shift")
    for j in range(kc + 1, kc + 4):
        s = [int(tab[i, j]) for i in range(4) if tab[i, j] >= 0]
        if _cancel_pairs(s):
            raise AssertionError(f"BG{bg} Z={Z}: col {j} does not cancel in core sum")
    # forward-substitution order for p1..p3: each step a row with one unknown
    known = {kc}
    order = []
    remaining = set(range(4))
    while len(known) < 4:
        for i in sorted(remaining):
            unknowns = [j for j in range(kc, kc + 4) if tab[i, j] >= 0 and j not in known]
            if len(unknowns) == 1:
                j = unknowns[0]
                order.append((i, j, int(tab[i, j])))
                known.add(j)
                remaining.discard(i)
                break
        else:
            raise AssertionError(f"BG{bg} Z={Z}: cannot order core parity solve")
    # each extension row r carries one shift-0 identity at column kc + r
    for r in range(4, rows):
        ext = [j for j in range(kc + 4, cols) if tab[r, j] >= 0]
        if ext != [kc + r] or tab[r, kc + r] != 0:
            raise AssertionError(f"BG{bg} Z={Z}: extension row {r} structure unexpected")

    return LDPCGraph(
        bg=bg, Z=Z, kc=kc, rows=rows, cols=cols, max_deg=max_deg, tab=tab,
        ecol=ecol, eshift=eshift, evalid=evalid,
        p0_shift=surviving[0], core_order=tuple(order),
    )


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def encode(graph: LDPCGraph, info_bits: torch.Tensor,
           n_cols: int | None = None) -> torch.Tensor:
    """LDPC encode.

    info_bits: (batch, K) int8 in {0,1}; filler bits must already be 0.
    Returns (batch, n_cols*Z) int8, the mother codeword prefix (systematic
    first; rate matching punctures the first 2Z bits).  n_cols: mother-code
    columns needed (default all); TX skips the extension rows past the last
    transmitted bit.
    """
    g = graph
    Z, kc, tab = g.Z, g.kc, g.tab
    n_cols = g.cols if n_cols is None else min(n_cols, g.cols)
    n_ext = max(0, n_cols - kc - 4)
    B = info_bits.shape[0]
    c = info_bits.to(torch.uint8).reshape(B, kc, Z)
    blocks = [c[:, j] for j in range(kc)]            # each (B, Z)

    def row_acc(r: int, upto_col: int) -> torch.Tensor:
        acc = torch.zeros((B, Z), dtype=torch.uint8, device=c.device)
        for j in range(upto_col):
            s = int(tab[r, j])
            if s >= 0:
                acc = acc ^ torch.roll(blocks[j], -s, dims=-1)
        return acc

    s_info = [row_acc(i, kc) for i in range(4)]
    U = s_info[0] ^ s_info[1] ^ s_info[2] ^ s_info[3]
    parity = {kc: torch.roll(U, g.p0_shift, dims=-1)}
    for (i, j, vshift) in g.core_order:
        acc = s_info[i]
        for jj in range(kc, kc + 4):
            s = int(tab[i, jj])
            if s >= 0 and jj in parity and jj != j:
                acc = acc ^ torch.roll(parity[jj], -s, dims=-1)
        parity[j] = torch.roll(acc, vshift, dims=-1)
    blocks += [parity[j] for j in range(kc, kc + 4)]
    for r in range(4, 4 + n_ext):
        blocks.append(row_acc(r, kc + 4))
    return torch.stack(blocks, dim=1).reshape(B, n_cols * Z).to(torch.int8)


# --------------------------------------------------------------------------
# Decoder (flooding normalized min-sum)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _decode_indices(bg: int, Z: int):
    """Gather indices for the lifted graph at (bg, Z)."""
    g = build_graph(bg, Z)
    RE = g.rows * g.max_deg
    shifts = g.eshift.reshape(RE)
    k = np.arange(Z)[None, :]
    idx_cn = (k + shifts[:, None]) % Z      # vn -> cn lane map
    idx_vn = (k - shifts[:, None]) % Z      # cn -> vn lane map
    return g, g.ecol.reshape(RE), idx_cn, idx_vn, g.evalid.reshape(RE)


def decode(graph: LDPCGraph, llr: torch.Tensor, n_iters: int = 20,
           alpha: float = 0.8125, early_stop: bool = True):
    """Flooding normalized min-sum decode.

    llr: (batch, cols*Z) float; > 0 means bit 0.  Punctured positions carry
    0, filler positions a large positive value.  early_stop ends the loop
    once every code block satisfies parity (the JAX reference does so on
    the CPU).  Returns (bits (batch, K) int8, parity_ok (batch,) bool,
    iters_used int).
    """
    g, col_np, idx_cn_np, idx_vn_np, valid_np = _decode_indices(graph.bg, graph.Z)
    dev = llr.device
    B = llr.shape[0]
    Z, C, R, D = g.Z, g.cols, g.rows, g.max_deg
    RE = R * D

    col_ids = torch.as_tensor(col_np, dtype=torch.long, device=dev)
    idx_cn = torch.as_tensor(idx_cn_np, dtype=torch.long, device=dev)[None].expand(B, RE, Z)
    idx_vn = torch.as_tensor(idx_vn_np, dtype=torch.long, device=dev)[None].expand(B, RE, Z)
    valid_rd = torch.as_tensor(valid_np, device=dev).reshape(1, R, D, 1)
    d_iota = torch.arange(D, device=dev).reshape(1, 1, D, 1)
    llr_cols = torch.cat([llr.reshape(B, C, Z).to(torch.float32),
                          torch.zeros((B, 1, Z), dtype=torch.float32, device=dev)], dim=1)

    def vn_totals(c2v_cn):
        c2v_vn = torch.gather(c2v_cn, -1, idx_vn)
        tot = torch.zeros((B, C + 1, Z), dtype=torch.float32, device=dev)
        tot.index_add_(1, col_ids, c2v_vn)
        return llr_cols + tot, c2v_vn

    def cn_update(c2v_cn):
        tot, c2v_vn = vn_totals(c2v_cn)
        v2c_vn = tot[:, col_ids] - c2v_vn
        m = torch.gather(v2c_vn, -1, idx_cn).reshape(B, R, D, Z)
        mag = torch.where(valid_rd, m.abs(), _BIG)
        neg = valid_rd & (m < 0)
        min1 = mag.amin(dim=2, keepdim=True)
        is_min = d_iota == mag.argmin(dim=2, keepdim=True)
        min2 = torch.where(is_min, _BIG, mag).amin(dim=2, keepdim=True)
        sign_tot = neg.sum(dim=2, keepdim=True) & 1
        out_mag = torch.where(is_min, min2, min1) * np.float32(alpha)
        out_neg = (sign_tot ^ neg.long()).bool()
        c2v = torch.where(out_neg, -out_mag, out_mag)
        c2v = torch.where(valid_rd, c2v, 0.0)
        return c2v.reshape(B, RE, Z)

    def hard_bits(c2v_cn):
        tot, _ = vn_totals(c2v_cn)
        return (tot[:, :C] < 0).to(torch.int8)

    def parity_ok(bits):
        b = torch.cat([bits, bits.new_zeros((B, 1, Z))], dim=1)
        vals = torch.gather(b[:, col_ids], -1, idx_cn)
        syn = vals.reshape(B, R, D, Z).sum(dim=2) & 1
        return torch.all(syn.reshape(B, -1) == 0, dim=1)

    c2v = torch.zeros((B, RE, Z), dtype=torch.float32, device=dev)
    iters = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    while iters < n_iters:
        c2v = cn_update(c2v)
        iters += 1
        if early_stop:
            done = parity_ok(hard_bits(c2v))
            if bool(done.all()):
                break
    if not early_stop:
        done = parity_ok(hard_bits(c2v))
    bits = hard_bits(c2v).reshape(B, C * Z)
    return bits[:, : g.K], done, iters


# --------------------------------------------------------------------------
# numpy reference helpers (tests)
# --------------------------------------------------------------------------

def check_parity_np(graph: LDPCGraph, codeword: np.ndarray) -> bool:
    """Verify H @ c == 0 over GF(2) for a (cols*Z,) codeword."""
    g = graph
    c = np.asarray(codeword).reshape(g.cols, g.Z)
    for r in range(g.rows):
        syn = np.zeros(g.Z, dtype=np.int64)
        for j in range(g.cols):
            s = int(g.tab[r, j])
            if s >= 0:
                syn ^= np.roll(c[j], -s)
        if syn.any():
            return False
    return True
