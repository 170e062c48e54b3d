"""NR polar coding (TS 38.212 §5.3.1 / §5.4.1): encode + CRC-aided SCL decode.

Port of openairinterface5g_tpu/coding/polar.py.

* Parameters (frozen set, rate-matching pattern, interleavers) are built on
  the host in numpy per static (K, E, n_max, IL, n_PC), as there.
* The encoder is GF(2) linear in the payload: the input interleaver, the
  parity-check (PC) register walk, the polar transform and every bit
  selection fold into one (K, E) generator matrix per configuration, built
  on the host, so an encode is one matrix product mod 2 (bit-equal to the
  JAX package's scan over N).
* Decoding is successive-cancellation list (SCL) with the L paths as a
  tensor axis.  The JAX package unrolls its recursion at trace time; here
  the recursion is walked once per configuration into a flat schedule
  (``_schedule``: f and g steps, rate-0 subtrees, PC and info leaves) and a
  decode runs that list with an explicit stack of the tree's LLRs and
  partial sums.  Rate-0 subtrees collapse into one metric update, as there.
  The prune keeps the L best of 2L candidates by a *stable* argsort, as
  ``jnp.argsort`` does: punctured and shortened positions give exact metric
  ties, and the tie order decides the surviving paths.  The walk never
  syncs with the host.

Bit/LLR conventions: bits in {0,1}; LLR > 0 means bit == 0.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..data.tables import polar_reliability_sequence
from .crc import CRC_POLYS, crc_compute

# TS 38.212 Table 5.4.1.1-1 sub-block interleaver pattern
SUBBLOCK_PERM = np.array(
    [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19,
     12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31],
    dtype=np.int32,
)

# TS 38.212 Table 5.3.1.1-1 interleaving pattern Pi_IL_max (K_IL_max = 164)
_PI_IL_MAX = np.array(
    [0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34,
     42, 45, 49, 50, 51, 53, 54, 56, 58, 59, 61, 62, 65, 66,
     67, 69, 70, 71, 72, 76, 77, 81, 82, 83, 87, 88, 89, 91,
     93, 95, 98, 101, 104, 106, 108, 110, 111, 113, 115, 118, 119, 120,
     122, 123, 126, 127, 129, 132, 134, 138, 139, 140, 1, 3, 5, 8,
     10, 15, 21, 27, 29, 32, 35, 43, 46, 52, 55, 57, 60, 63,
     68, 73, 78, 84, 90, 92, 94, 96, 99, 102, 105, 107, 109, 112,
     114, 116, 121, 124, 128, 130, 133, 135, 141, 6, 11, 16, 22, 30,
     33, 36, 44, 47, 64, 74, 79, 85, 97, 100, 103, 117, 125, 131,
     136, 142, 12, 17, 23, 37, 48, 75, 80, 86, 137, 143, 13, 18,
     38, 144, 39, 145, 40, 146, 41, 147, 148, 149, 150, 151, 152, 153,
     154, 155, 156, 157, 158, 159, 160, 161, 162, 163],
    dtype=np.int32,
)

_PBIG = 1e9          # metric of a dead path (only path 0 lives at the start)


@dataclasses.dataclass(frozen=True)
class PolarParams:
    K: int                  # payload + CRC bits
    E: int                  # rate-matched output length
    N: int                  # mother code length
    n_pc: int
    n_pc_wm: int
    il_pattern: tuple       # (K,) input interleaver Pi(k)
    info_mask: tuple        # (N,) 1 = info/pc position
    pc_mask: tuple          # (N,) 1 = parity-check position
    rm_indices: tuple       # (E,) e_k = y[rm_indices[k]] after subblock interleave
    channel_perm: tuple     # (E,) channel interleaver (I_BIL)
    mode: str               # 'repetition' | 'puncturing' | 'shortening'

    @property
    def info_positions(self) -> np.ndarray:
        m = np.array(self.info_mask, bool) & ~np.array(self.pc_mask, bool)
        return np.nonzero(m)[0]


def _compute_n(K: int, E: int, n_max: int) -> int:
    cl = math.ceil(math.log2(E))
    if E <= (9 / 8) * 2 ** (cl - 1) and K / E < 9 / 16:
        n1 = cl - 1
    else:
        n1 = cl
    n2 = math.ceil(math.log2(K * 8))  # R_min = 1/8
    return max(min(n1, n2, n_max), 5)


def _channel_interleaver(E: int, i_bil: bool) -> np.ndarray:
    """TS 38.212 §5.4.1.3 triangular channel interleaver (UL only)."""
    if not i_bil:
        return np.arange(E, dtype=np.int32)
    T = 0
    while T * (T + 1) // 2 < E:
        T += 1
    v = -np.ones((T, T), dtype=np.int64)
    k = 0
    for i in range(T):
        for j in range(T - i):
            if k < E:
                v[i, j] = k
            k += 1
    out = v.T[v.T >= 0]
    return out.astype(np.int32)


def _subblock_interleaver(N: int) -> np.ndarray:
    """J: position m of y takes d[J[m]] (TS 38.212 §5.4.1.1)."""
    nb = N // 32
    return (SUBBLOCK_PERM[np.arange(N) // nb] * nb + np.arange(N) % nb).astype(np.int32)


@functools.lru_cache(maxsize=256)
def polar_params(K: int, E: int, n_max: int, i_il: bool, n_pc: int = 0, n_pc_wm: int = 0,
                 i_bil: bool = False) -> PolarParams:
    """Build all static patterns for one polar configuration (TS 38.212
    §5.3.1.2 frozen set, §5.4.1 rate matching)."""
    N = 1 << _compute_n(K + n_pc, E, n_max)
    q = polar_reliability_sequence(N)

    # input interleaver (IL): K-bit pattern from Pi_IL_max
    if i_il:
        kmax = 164
        il = (_PI_IL_MAX[_PI_IL_MAX >= (kmax - K)] - (kmax - K)).astype(np.int32)
        assert len(il) == K
    else:
        il = np.arange(K, dtype=np.int32)

    J = _subblock_interleaver(N)

    # pre-frozen positions from rate matching
    prefrozen = np.zeros(N, dtype=bool)
    Kp = K + n_pc
    if E < N:
        if Kp / E <= 7 / 16:
            mode = "puncturing"
            prefrozen[J[: N - E]] = True
            if E / N >= 3 / 4:
                limit = math.ceil((3 * N - 2 * E) / 4)
            else:
                limit = math.ceil((9 * N - 4 * E) / 16)
            prefrozen[:limit] = True
        else:
            mode = "shortening"
            prefrozen[J[E:]] = True
    else:
        mode = "repetition"

    # (K + n_pc) most reliable positions not pre-frozen
    usable = q[~prefrozen[q]]          # ascending reliability
    qi = usable[-Kp:]                  # most reliable Kp positions (ascending rel.)
    info_mask = np.zeros(N, dtype=bool)
    info_mask[qi] = True
    pc_mask = np.zeros(N, dtype=bool)
    if n_pc > 0:
        # least reliable (n_pc - n_pc_wm) of the selected set
        pc_mask[qi[: n_pc - n_pc_wm]] = True
        if n_pc_wm > 0:
            # TS 38.212 §5.3.1.2: among the most reliable positions, the one(s)
            # of minimum row weight; row weight of i = 2^{popcount(i)}
            cand = qi[n_pc - n_pc_wm:]
            w = np.array([bin(int(x)).count("1") for x in cand])
            sel = cand[w == w.min()][-n_pc_wm:]
            pc_mask[sel] = True

    # rate-matching output: e_k = y[idx]
    if mode == "repetition":
        rm = np.arange(E, dtype=np.int32) % N
    elif mode == "puncturing":
        rm = np.arange(E, dtype=np.int32) + (N - E)
    else:
        rm = np.arange(E, dtype=np.int32)

    return PolarParams(
        K=K, E=E, N=N, n_pc=n_pc, n_pc_wm=n_pc_wm,
        il_pattern=tuple(il.tolist()),
        info_mask=tuple(info_mask.astype(np.int8).tolist()),
        pc_mask=tuple(pc_mask.astype(np.int8).tolist()),
        rm_indices=tuple(rm.tolist()),
        channel_perm=tuple(_channel_interleaver(E, i_bil).tolist()),
        mode=mode,
    )


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """x = u @ G_N over GF(2), G_N = kron^n [[1,0],[1,1]] (no bit reversal)."""
    N = u.shape[-1]
    lead = u.shape[:-1]
    x = u
    m = 1
    while m < N:
        x = x.reshape(*lead, N // (2 * m), 2, m)
        x = torch.stack([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-2).reshape(*lead, N)
        m *= 2
    return x


def _u_map(p: PolarParams) -> np.ndarray:
    """(K, N) uint8 over GF(2): u = payload @ W, with the input interleaver
    and the PC bits (TS 38.212 §5.3.1.2: a 5-bit register, cyclically
    shifted at every position, XOR-fed by every non-PC bit, read at the PC
    positions).  Each register cell holds the set of payload bits it sums,
    as a bit mask."""
    info = np.array(p.info_mask, bool)
    pc = np.array(p.pc_mask, bool)
    data_pos = np.nonzero(info & ~pc)[0]
    idx_of = {int(pos): k for k, pos in enumerate(data_pos)}
    reg = [0] * 5
    u = [0] * p.N
    for i in range(p.N):
        reg = reg[1:] + reg[:1]
        if pc[i]:
            u[i] = reg[0]
        elif i in idx_of:
            u[i] = 1 << idx_of[i]
        if not pc[i]:
            reg[0] ^= u[i]
    W_c = np.array([[(u[i] >> k) & 1 for i in range(p.N)] for k in range(p.K)], np.uint8)
    W = np.zeros_like(W_c)
    W[np.array(p.il_pattern)] = W_c           # c_k = payload[il[k]]
    return W


def _mother_index(p: PolarParams) -> np.ndarray:
    """(E,) the mother-code bit d[idx[k]] sent as output bit k: the channel
    interleaver, bit selection and sub-block interleaver composed."""
    J = _subblock_interleaver(p.N)
    return J[np.array(p.rm_indices)[np.array(p.channel_perm)]]


@functools.lru_cache(maxsize=64)
def _generator(p: PolarParams, device: torch.device) -> torch.Tensor:
    """(K, E) float32 {0,1}: out = payload @ G mod 2 (the whole encoder)."""
    W = torch.as_tensor(_u_map(p))
    G = polar_transform(W)[:, torch.as_tensor(_mother_index(p), dtype=torch.long)]
    return G.to(device=device, dtype=torch.float32)


def encode(params: PolarParams, payload: torch.Tensor) -> torch.Tensor:
    """(batch, K) payload (incl. CRC) -> (batch, E) rate-matched bits, int8."""
    G = _generator(params, payload.device)
    acc = payload.to(torch.float32) @ G        # sums of <= K ones: exact
    return (acc.to(torch.int32) & 1).to(torch.int8)


@functools.lru_cache(maxsize=64)
def _recovery(p: PolarParams, device: torch.device):
    """Index tensors of rate_recover_llr on `device`: the channel
    deinterleaver, the bit selection and the sub-block deinterleaver."""
    cperm = np.array(p.channel_perm)
    inv = np.empty_like(cperm)
    inv[cperm] = np.arange(p.E)
    J = _subblock_interleaver(p.N)
    jinv = np.empty_like(J)
    jinv[J] = np.arange(p.N)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return on(inv), on(p.rm_indices), on(jinv)


def rate_recover_llr(params: PolarParams, llr_e: torch.Tensor, big: float = 1e4) -> torch.Tensor:
    """(batch, E) channel LLRs -> (batch, N) mother-code LLRs: undo the
    channel interleaver, sum repetitions, give shortened bits the LLR `big`
    (known zeros), leave punctured ones at 0, undo the sub-block interleaver."""
    p = params
    inv, rm, jinv = _recovery(p, llr_e.device)
    e = llr_e[..., inv]
    lead = llr_e.shape[:-1]
    if p.mode == "repetition":
        y = e[..., : p.N]
        for s in range(p.N, p.E, p.N):         # repetitions add in order
            part = e[..., s: s + p.N]
            y = torch.cat([y[..., : part.shape[-1]] + part, y[..., part.shape[-1]:]], dim=-1)
    else:
        y = torch.zeros((*lead, p.N), dtype=llr_e.dtype, device=llr_e.device)
        y[..., rm] = e
        if p.mode == "shortening":
            y[..., p.E:] += big
    return y[..., jinv]


# --------------------------------------------------------------------------
# SCL decoder
# --------------------------------------------------------------------------

def _f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check-node combine: min-sum with the correction term of the exact
    log-domain f (boxplus):
    f(a,b) = sign(a)sign(b)min(|a|,|b|) + log((1+e^-|a+b|)/(1+e^-|a-b|))."""
    ms = torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())
    corr = torch.log1p(torch.exp(-(a + b).abs())) - torch.log1p(torch.exp(-(a - b).abs()))
    return ms + corr


@functools.lru_cache(maxsize=64)
def _schedule(p: PolarParams) -> tuple:
    """The SC tree of `p` walked once, left to right, as a flat list of
    steps: ("f", h) descends left, ("g", h) right, ("combine",) returns the
    partial sums of a node, ("rate0", M) is an all-frozen subtree of M
    leaves, ("pc", i) and ("info", i) leaves."""
    info = np.array(p.info_mask, bool)
    pc = np.array(p.pc_mask, bool)
    ops = []
    leaf = 0

    def node(M: int) -> None:
        nonlocal leaf
        if not info[leaf: leaf + M].any():
            leaf += M
            ops.append(("rate0", M))
        elif M == 1:
            ops.append(("pc" if pc[leaf] else "info", leaf))
            leaf += 1
        else:
            ops.append(("f", M // 2))
            node(M // 2)
            ops.append(("g", M // 2))
            node(M // 2)
            ops.append(("combine",))

    node(p.N)
    assert leaf == p.N
    return tuple(ops)


@functools.lru_cache(maxsize=64)
def _payload_order(p: PolarParams, device: torch.device):
    """(data positions, inverse input interleaver) on `device`."""
    return (torch.as_tensor(p.info_positions, dtype=torch.long, device=device),
            torch.as_tensor(np.argsort(np.array(p.il_pattern)), dtype=torch.long, device=device))


def _take_paths(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(B, L, ...) t, (B, L) path indices -> t's paths in the order of src."""
    idx = src.reshape(*src.shape, *([1] * (t.dim() - 2))).expand(*src.shape, *t.shape[2:])
    return torch.gather(t, 1, idx)


def scl_decode(params: PolarParams, llr_n: torch.Tensor, list_size: int = 8):
    """SCL decode of (B, N) mother-code LLRs.

    Returns (u_cands (B, L, K) int8 payload-bit candidates ordered best-first
    by path metric, metrics (B, L) float32).  CRC selection is up to the
    caller (decode_with_crc below).
    """
    p = params
    B, N = llr_n.shape
    L = list_size
    dev = llr_n.device
    use_pc = p.n_pc > 0
    metrics = torch.zeros((B, L), dtype=torch.float32, device=dev)
    metrics[:, 1:] += _PBIG                           # only path 0 lives
    llr = llr_n[:, None, :].expand(B, L, N).to(torch.float32)
    u_hist = torch.zeros((B, L, N), dtype=torch.int8, device=dev)
    reg = torch.zeros((B, L, 5), dtype=torch.int8, device=dev)
    zero_bits = torch.zeros((B, L), dtype=torch.int8, device=dev)
    branch_bits = torch.cat([zero_bits, torch.ones_like(zero_bits)], dim=1)   # (B, 2L)
    stack = []
    x = None
    for op in _schedule(p):
        kind = op[0]
        if kind == "f":
            h = op[1]
            stack.append(llr)
            llr = _f_minsum(llr[..., :h], llr[..., h:])
        elif kind == "g":
            h = op[1]
            llr_s = stack.pop()
            llr = llr_s[..., h:] + (1 - 2 * x.to(torch.float32)) * llr_s[..., :h]
            stack.append(x)
        elif kind == "combine":
            x_l = stack.pop()
            x = torch.cat([x_l ^ x, x], dim=-1)
        elif kind == "rate0":
            M = op[1]
            metrics = metrics + torch.sum(torch.where(llr < 0, llr.abs(), 0.0), dim=-1)
            if use_pc and M % 5:
                reg = torch.roll(reg, -(M % 5), dims=-1)
            x = torch.zeros(llr.shape, dtype=torch.int8, device=dev)
        else:
            i = op[1]
            lv = llr[..., 0]
            pen0 = torch.where(lv < 0, lv.abs(), 0.0)
            pen1 = torch.where(lv > 0, lv.abs(), 0.0)
            if use_pc:
                reg = torch.roll(reg, -1, dims=-1)
            if kind == "pc":
                bits = reg[..., 0]
                metrics = metrics + torch.where(bits == 0, pen0, pen1)
            else:
                # branch into 2L candidates, keep the L best (stable order)
                metrics2 = torch.cat([metrics + pen0, metrics + pen1], dim=1)
                order = torch.argsort(metrics2, dim=1, stable=True)[:, :L]
                metrics = torch.gather(metrics2, 1, order)
                bits = torch.gather(branch_bits, 1, order)
                src = order % L
                stack = [_take_paths(t, src) for t in stack]
                u_hist = _take_paths(u_hist, src)
                reg = _take_paths(reg, src)
                if use_pc:
                    reg = torch.cat([reg[..., :1] ^ bits[..., None], reg[..., 1:]], dim=-1)
            u_hist[:, :, i] = bits
            x = bits[..., None]
    data_pos, il_inv = _payload_order(p, dev)
    c = u_hist[:, :, data_pos]                        # c_k in encode order
    return c[..., il_inv], metrics                    # payload[j] = c[il^-1[j]]


def decode_with_crc(params: PolarParams, llr_e: torch.Tensor, crc_name: str,
                    list_size: int = 8, crc_mask: torch.Tensor | None = None):
    """Full RX: rate recovery + SCL + CRC path selection.

    crc_mask: optional (Lcrc,) bits XORed onto the computed CRC before the
    comparison (the RNTI scrambling of a DCI CRC).
    Returns (payload_bits (B, A), crc_pass (B,)): the first passing path in
    metric order, else the best-metric path.
    """
    cands, _ = scl_decode(params, rate_recover_llr(params, llr_e), list_size)
    Lc, _ = CRC_POLYS[crc_name]
    payload, rx_crc = cands[..., :-Lc], cands[..., -Lc:]
    calc = crc_compute(payload, crc_name)
    if crc_mask is not None:
        calc = calc ^ crc_mask.to(calc.dtype)
    ok = torch.all(calc == rx_crc, dim=-1)            # (B, L)
    return select_path(payload, ok)


def select_path(payload: torch.Tensor, ok: torch.Tensor):
    """(B, L, A) candidates, (B, L) CRC flags -> ((B, A) the first passing
    candidate, else candidate 0; (B,) any passing)."""
    any_ok = torch.any(ok, dim=1)
    pick = torch.where(any_ok, torch.argmax(ok.to(torch.uint8), dim=1), 0)
    sel = torch.gather(payload, 1, pick[:, None, None].expand(-1, 1, payload.shape[-1]))[:, 0]
    return sel, any_ok
