"""LTE tail-biting convolutional code and its Viterbi decoder (TS 36.212
§5.1.3.1): K = 7, rate 1/3, generators 133/171/165 octal.

Port of openairinterface5g_tpu/coding/viterbi.py (the reference's
ccoding_byte_lte.c and viterbi_lte.c).  The state is the 6 previous input
bits, the newest at bit 5, so a step from state s on input b goes to
(b << 5) | (s >> 1), and the predecessors of s' are 2 (s' & 31) + j.

* The encoder is feedforward: output i of step k is the parity of the
  generator's taps over the circular window b[k-6 .. k], one gather and a
  sum mod 2, with no loop over bits.
* The decoder runs the add-compare-select over the 3x-repeated sequence and
  keeps the middle copy (the circular Viterbi of the reference's tail-biting
  decode).  A step adds each state's two incoming branch metrics to its
  predecessors' metrics (a view of the (B, 64) metrics, no gather), keeps
  the larger, and subtracts the row maximum: 5 eager launches a step, as the
  turbo decoder's steps.  Predecessor 1 wins only where it is strictly
  larger, and the traceback starts from the lowest-index best state: the
  first-index rule of the JAX package's argmax, so ties (every metric ties
  at step 0) decide as there.  The traceback is one gather a step from a
  table of each step's surviving predecessors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

G_OCT = (0o133, 0o171, 0o165)
K_CONSTRAINT = 7
NSTATES = 64


@functools.lru_cache(maxsize=1)
def _tables():
    """next_state (64, 2) and output bits (64, 2, 3) for input b."""
    nxt = np.zeros((NSTATES, 2), np.int32)
    out = np.zeros((NSTATES, 2, 3), np.int32)
    for s in range(NSTATES):
        for b in (0, 1):
            reg = (b << 6) | s
            nxt[s, b] = reg >> 1
            for gi, g in enumerate(G_OCT):
                out[s, b, gi] = bin(reg & g).count("1") & 1
    return nxt, out


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device):
    """(taps (7, 3) int32: bit m of each generator, the tap on b[k-6+m];
    sgn (64, 2, 3): the signs 1 - 2 out of the branch into state s' from its
    predecessor j; base (64,) long: 2 (s' & 31))."""
    taps = np.array([[(g >> m) & 1 for g in G_OCT] for m in range(7)], np.int32)
    _, out = _tables()
    s = np.arange(NSTATES)
    pred = 2 * (s & 31)[:, None] + np.arange(2)[None, :]          # (64, 2)
    sgn = (1.0 - 2.0 * out[pred, (s >> 5)[:, None]]).astype(np.float32)
    return (torch.as_tensor(taps, device=device), torch.as_tensor(sgn, device=device),
            torch.as_tensor(2 * (s & 31), dtype=torch.long, device=device))


def encode(bits: torch.Tensor) -> torch.Tensor:
    """(B, L) bits -> (B, 3L) int8 coded bits, the triples of each step in
    turn; tail-biting: the register starts from the block's last 6 bits."""
    taps, _, _ = _consts(bits.device)
    B, L = bits.shape
    win = (torch.arange(L, device=bits.device)[:, None]
           + torch.arange(-6, 1, device=bits.device)[None, :]) % L         # (L, 7)
    w = bits.to(torch.int32)[:, win]                                       # (B, L, 7)
    out = (w[..., None] & taps).sum(dim=2) & 1                             # (B, L, 3)
    return out.reshape(B, 3 * L).to(torch.int8)


def decode(llrs: torch.Tensor) -> torch.Tensor:
    """(B, 3L) LLRs (positive = bit 0) in encode's order -> (B, L) int8 bits."""
    _, sgn, base = _consts(llrs.device)
    B = llrs.shape[0]
    L = llrs.shape[-1] // 3
    l3 = llrs.reshape(B, L, 3).to(torch.float32)
    # branch metrics of every state's two incoming branches, per step of one
    # copy: 0.5 * (s0 l0 + s1 l1 + s2 l2), summed in that order
    t = l3[:, :, None, None, :] * sgn                                      # (B, L, 64, 2, 3)
    bm = (0.5 * ((t[..., 0] + t[..., 1]) + t[..., 2])).transpose(0, 1).contiguous()
    bm = bm.view(L, B, 2, 32, 2)
    pm = llrs.new_zeros((B, NSTATES), dtype=torch.float32)
    win = torch.empty((3 * L, B, NSTATES), dtype=torch.bool, device=llrs.device)
    for k in range(3 * L):
        cand = (pm.view(B, 1, 32, 2) + bm[k % L]).view(B, NSTATES, 2)
        torch.gt(cand[..., 1], cand[..., 0], out=win[k])
        new = torch.amax(cand, dim=-1)
        pm = new - new.amax(dim=-1, keepdim=True)
    # each step's surviving predecessor of every state, then the traceback
    # from the lowest-index best end state; the input bit of step k is bit 5
    # of the state after it
    prev = base + win.to(torch.long)                                       # (3L, B, 64)
    idx = torch.arange(NSTATES, device=llrs.device)
    best = pm == pm.amax(dim=-1, keepdim=True)
    state = torch.where(best, idx, NSTATES).amin(dim=-1, keepdim=True)     # (B, 1)
    for k in range(3 * L - 1, 2 * L - 1, -1):
        state = prev[k].gather(1, state)
    kept = []
    for k in range(2 * L - 1, L - 1, -1):
        kept.append(state)
        state = prev[k].gather(1, state)
    return (torch.cat(kept[::-1], dim=1) >> 5).to(torch.int8)


def streams(d: torch.Tensor) -> torch.Tensor:
    """encode's per-step triples (B, 3L) -> the three streams d0|d1|d2 that
    rate matching reads (TS 36.212 §5.1.4.2)."""
    B, L = d.shape[0], d.shape[-1] // 3
    return d.view(B, L, 3).transpose(1, 2).reshape(B, 3 * L)


def triples(d_flat: torch.Tensor) -> torch.Tensor:
    """The streams d0|d1|d2 (B, 3L) -> decode's per-step triples."""
    B, L = d_flat.shape[0], d_flat.shape[-1] // 3
    return d_flat.view(B, 3, L).transpose(1, 2).reshape(B, 3 * L)
