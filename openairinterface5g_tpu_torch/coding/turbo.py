"""LTE turbo codec (TS 36.212 §5.1.3.2): the PCCC encoder and the iterative
max-log-MAP decoder.

Port of openairinterface5g_tpu/coding/turbo.py (the reference's
3gpplte_sse.c encoder and 3gpplte_turbo_decoder_sse_16bit.c decoder).
Polynomials: g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3; the 8-state
trellis is three (8, 2) host tables.

* The encoder has no loop over bits.  The RSC code is GF(2)-linear from the
  zero state: with s = (d1, d2, d3), s_k = sum_{j<k} A^(k-1-j) b x_j, and
  A^7 = I (g0 is primitive), so s_k is a product of the prefix parities of
  the 7 residue classes of j with a (7, 14, 3) host table.  The parity is
  z_k = x_k ^ d1_k ^ d2_k; the tail comes from the final state by table.
* The decoder's forward and backward recursions run together in one loop
  of K + 3 steps: each state has exactly two predecessors (forward) and two
  successors (backward), so each step is one gather of 16 pairs, one add,
  a max over each pair, and the per-direction normalization (the max is
  subtracted at every step, -1e30 marks unreachable states, float32).  The
  loop is eager: 5 small launches a step, 2 SISOs an iteration.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.lte_tables import QPP_BY_K

_NEG = np.float32(-1e30)


def _step(state: int, x: int) -> tuple[int, int]:
    """One RSC step: state = (d1, d2, d3) packed as d1*4 + d2*2 + d3."""
    d1, d2, d3 = (state >> 2) & 1, (state >> 1) & 1, state & 1
    a = x ^ d2 ^ d3                  # feedback g0 = 1 + D^2 + D^3
    z = a ^ d1 ^ d3                  # parity   g1 = 1 + D + D^3
    return (a << 2) | (d1 << 1) | d2, z


@functools.lru_cache(maxsize=1)
def _tables():
    """(nxt, par, term_x): next state and parity per (state, input), and the
    termination input x = d2 ^ d3 that zeroes the feedback."""
    nxt = np.zeros((8, 2), np.int32)
    par = np.zeros((8, 2), np.int32)
    for s in range(8):
        for x in (0, 1):
            nxt[s, x], par[s, x] = _step(s, x)
    term_x = np.array([((s >> 1) & 1) ^ (s & 1) for s in range(8)], np.int32)
    return nxt, par, term_x


@functools.lru_cache(maxsize=256)
def qpp_interleaver(K: int) -> np.ndarray:
    """(K,) permutation Pi: c'_i = c_{Pi(i)} (TS 36.212 §5.1.3.2.3)."""
    f1, f2 = QPP_BY_K[K]
    i = np.arange(K, dtype=np.int64)
    return ((f1 * i + f2 * i * i) % K).astype(np.int32)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _rsc_linear():
    """(P, T, tail): the state period P of the zero-input RSC; T (P, 2P, 3) so
    that s_{qP+r} = sum_c T[r, c] [C_q, C_{q-1}]_c (mod 2), C_q the inclusive
    prefix parities of the residue classes over rows 0..q; tail (8, 6) the
    termination's (x_K, x_K+1, x_K+2, z_K, z_K+1, z_K+2) per final state."""
    A = np.array([[0, 1, 1], [1, 0, 0], [0, 1, 0]], np.int64)   # s' = A s + b x
    b = np.array([1, 0, 0], np.int64)
    pows = [np.eye(3, dtype=np.int64)]
    while True:
        pows.append(pows[-1] @ A % 2)
        if np.array_equal(pows[-1], pows[0]):
            break
    P = len(pows) - 1
    coef = [pows[r] @ b % 2 for r in range(P)]                  # A^r b
    T = np.zeros((P, 2 * P, 3), np.float32)
    for r in range(P):
        for c in range(P):
            T[r, c if c < r else P + c] = coef[(r - 1 - c) % P]
    nxt, par, term_x = _tables()
    tail = np.zeros((8, 6), np.int8)
    for s0 in range(8):
        s = s0
        for i in range(3):
            x = term_x[s]
            tail[s0, i], tail[s0, 3 + i] = x, par[s, x]
            s = nxt[s, x]
    return P, T, tail


@functools.lru_cache(maxsize=8)
def _rsc_consts(device: torch.device):
    P, T, tail = _rsc_linear()
    return P, torch.as_tensor(T, device=device), torch.as_tensor(tail, device=device)


def _rsc_encode(x: torch.Tensor):
    """(N, K) bits -> (parity (N, K) int8, tail (N, 6) int8: x_t, z_t of the
    three termination steps)."""
    P, T, tail = _rsc_consts(x.device)
    N, K = x.shape
    Q = -(-(K + 1) // P)                 # rows covering states s_0 .. s_K
    xp = torch.zeros((N, Q * P), dtype=torch.int32, device=x.device)
    xp[:, :K] = x
    C = torch.cumsum(xp.view(N, Q, P), dim=1) % 2
    Cprev = torch.cat([torch.zeros_like(C[:, :1]), C[:, :-1]], dim=1)
    feats = torch.cat([C, Cprev], dim=-1).to(torch.float32)      # (N, Q, 2P), 0/1
    s = torch.einsum("nqc,rcs->nqrs", feats, T).to(torch.int32) % 2
    s = s.reshape(N, Q * P, 3)[:, : K + 1]                      # s_0 .. s_K
    z = (x.to(torch.int32) ^ s[:, :K, 0] ^ s[:, :K, 1]).to(torch.int8)
    final = 4 * s[:, K, 0] + 2 * s[:, K, 1] + s[:, K, 2]
    return z, tail[final]


def encode(bits: torch.Tensor):
    """(B, K) info bits -> (d0, d1, d2), each (B, K+4) int8 (TS 36.212
    §5.1.3.2): systematic, parity 1, parity 2; the last 4 positions of each
    stream carry the multiplexed termination bits (Table 5.1.3-1)."""
    K = bits.shape[-1]
    b = bits.to(torch.int8)
    pi = torch.as_tensor(qpp_interleaver(K), dtype=torch.long, device=bits.device)
    z1, t1 = _rsc_encode(b)
    z2, t2 = _rsc_encode(b[:, pi])
    # t = (x_K, x_K+1, x_K+2, z_K, z_K+1, z_K+2); 36.212 5.1.3.2.2:
    # d0 tail = X(K) Z(K+1) X'(K) Z'(K+1), d1 tail = Z(K) X(K+2) Z'(K) X'(K+2),
    # d2 tail = X(K+1) Z(K+2) X'(K+1) Z'(K+2)
    d0 = torch.cat([b, t1[:, [0, 4]], t2[:, [0, 4]]], dim=-1)
    d1 = torch.cat([z1, t1[:, [3, 2]], t2[:, [3, 2]]], dim=-1)
    d2 = torch.cat([z2, t1[:, [1, 5]], t2[:, [1, 5]]], dim=-1)
    return d0, d1, d2


# ---------------------------------------------------------------------------
# max-log-MAP decoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _trellis(device: torch.device):
    """Per device: the (32,) gather index of one add-compare-select step over
    [alpha (8) | beta (8)] (state s' <- its two predecessors; state s <- its
    two successors, offset by 8), the predecessors' (state, input), nxt,
    and the branch signs xsgn (2,), zsgn (8, 2)."""
    nxt, par, _ = _tables()
    pred = [[(s, x) for s in range(8) for x in (0, 1) if nxt[s, x] == t] for t in range(8)]
    assert all(len(p) == 2 for p in pred)
    pred_s = np.array([[s for s, _ in p] for p in pred], np.int64)
    pred_x = np.array([[x for _, x in p] for p in pred], np.int64)
    idx = np.concatenate([pred_s, nxt.astype(np.int64) + 8]).reshape(-1)

    def on(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (on(idx), on(pred_s), on(pred_x), on(nxt, torch.long),
            on(1.0 - 2.0 * np.arange(2, dtype=np.float32)),
            on((1.0 - 2.0 * par).astype(np.float32)))


def _acs(cur: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """One add-compare-select step of both recursions: cur (N, 16) state
    metrics [alpha | beta], w (N, 16, 2) the branch metrics of each state's
    two incoming (alpha) or outgoing (beta) branches -> out (N, 16), each
    half normalized to a maximum of 0."""
    cand = torch.index_select(cur, 1, idx).view(-1, 16, 2)
    cand += w
    torch.amax(cand, dim=-1, out=out)
    halves = out.view(-1, 2, 8)
    halves -= halves.amax(dim=-1, keepdim=True)


def _siso(l_sys, l_par, l_a, l_sys_tail, l_par_tail):
    """One max-log-MAP SISO pass over the terminated 8-state trellis.

    l_sys/l_par/l_a: (N, K) LLRs (positive = bit 0); *_tail: (N, 3).
    Returns the extrinsic (N, K).
    """
    idx, pred_s, pred_x, nxt, xsgn, zsgn = _trellis(l_sys.device)
    N, K = l_sys.shape
    T = K + 3
    ls = torch.cat([l_sys + l_a, l_sys_tail], dim=-1)            # (N, T)
    lp = torch.cat([l_par, l_par_tail], dim=-1)
    # branch metrics g[n, t, s, x] = 0.5 ls sgn(x) + 0.5 lp sgn(z(s, x))
    g = (0.5 * ls)[..., None, None] * xsgn + (0.5 * lp)[..., None, None] * zsgn
    # step i: alpha's step t = i, beta's step t = T-1-i
    w = torch.cat([g[:, :, pred_s, pred_x], g.flip(1)], dim=2).transpose(0, 1).contiguous()
    H = torch.full((T + 1, N, 16), _NEG, dtype=torch.float32, device=l_sys.device)
    H[0, :, 0] = 0.0
    H[0, :, 8] = 0.0
    for i in range(T):
        _acs(H[i], idx, w[i], H[i + 1])
    # H[t] holds alpha_t and beta_{T-t}: the K info steps take alpha_t with
    # beta_{t+1} = H[T-1-t]
    alpha = H[:K, :, :8].transpose(0, 1)                         # (N, K, 8)
    beta_next = H[3: K + 3, :, 8:].flip(0).transpose(0, 1)      # (N, K, 8)
    tot = alpha[..., None] + g[:, :K] + beta_next[:, :, nxt]     # (N, K, 8, 2)
    llr = torch.amax(tot[..., 0], dim=-1) - torch.amax(tot[..., 1], dim=-1)
    return llr - (l_sys + l_a)


def decode(l_d0: torch.Tensor, l_d1: torch.Tensor, l_d2: torch.Tensor, n_iters: int = 6,
           ext_scale: float = 0.75):
    """(B, K+4) stream LLRs -> (bits (B, K) int8, llr (B, K)).

    SISO1 and SISO2 alternate for n_iters iterations (the reference's decoder
    loop without its CRC stop, which the caller adds); ext_scale damps the
    extrinsic, the usual max-log-MAP correction.
    """
    K = l_d0.shape[1] - 4
    dev = l_d0.device
    pi_np = qpp_interleaver(K)
    pi = torch.as_tensor(pi_np, dtype=torch.long, device=dev)
    inv = torch.as_tensor(np.argsort(pi_np), dtype=torch.long, device=dev)
    ls1, lp1, lp2 = l_d0[:, :K], l_d1[:, :K], l_d2[:, :K]
    ls2 = ls1[:, pi]
    # the tail LLRs (the demultiplexing of encode's termination bits)
    s1_t = torch.stack([l_d0[:, K], l_d1[:, K + 1], l_d2[:, K]], -1)
    p1_t = torch.stack([l_d1[:, K], l_d0[:, K + 1], l_d2[:, K + 1]], -1)
    s2_t = torch.stack([l_d0[:, K + 2], l_d1[:, K + 3], l_d2[:, K + 2]], -1)
    p2_t = torch.stack([l_d1[:, K + 2], l_d0[:, K + 3], l_d2[:, K + 3]], -1)
    sc = float(np.float32(ext_scale))
    le21 = torch.zeros_like(ls1)
    le12 = torch.zeros_like(ls1)
    for _ in range(n_iters):
        le12 = sc * _siso(ls1, lp1, le21, s1_t, p1_t)
        le21 = (sc * _siso(ls2, lp2, le12[:, pi], s2_t, p2_t))[:, inv]
    llr = ls1 + le12 + le21
    return (llr < 0).to(torch.int8), llr
