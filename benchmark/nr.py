"""The benchmark's plain reference of the NR uplink and downlink shared
channels.

TS 38.211 (numerology, Gold sequences, DMRS, QAM, OFDM), TS 38.212 (CRC,
segmentation, LDPC, rate matching) and TS 38.214 (MCS and TBS) written out
in NumPy and plain PyTorch, for one configuration family: CP-OFDM, a
rectangular allocation over the whole carrier, type-1 DMRS on CDM group 0
with no data beside it in one or more single symbols (additional
positions, as ``dmrs-AdditionalPosition`` pos1 gives symbols 2 and 11), 1 or
2 layers on ports 0 and 1, MCS table 1, redundancy version 0, no LBRM.

The downlink shared channel of this family (PDSCH, one codeword, q = 0,
n_SCID = 0, the DMRS without power boost as one CDM group without data
gives) is block for block the uplink one: TS 38.211 §7.3.1.1's scrambling
(c_init = n_RNTI 2^15 + q 2^14 + n_ID) and §7.4.1.1's DMRS sequence equal
§6.3.1.1's and §6.4.1.1.1.1's CP-OFDM formulas written here, and §7.3.1.3's
layer mapping and §7.3.1.5's mapping to resource elements equal the
uplink's.  So one ``Pusch`` reads both families' files (a transmitter's
file need not carry the receiver's fields), and ``transmit`` is also the
reference of the gNB's transmitter.

It imports nothing of the program under test and reads nothing it made
at run time.  The transmitter (``transmit``: ``codeword_bits``, then
``slot_grid``, then ``ofdm_modulate``) makes the uplink cells' waveforms
and judges the downlink cells' output; the receiver (``frontend_llrs``,
``recover``, ``decode``, ``desegment``) judges what the program received.
The receiver's estimator and detector are the ones the program states
(LS on the pilots averaged over the DMRS symbols, the frequency OCC split
of two ports, a moving average with replicate padding, linear
interpolation of the comb, MRC or the closed-form 2-layer MMSE, max-log
LLRs), so the two compare number for number.  ``frontend_llrs`` rounds its intermediate values with ``q``:
``exact`` for the reference, ``bf16`` for the control.

Bits are 0/1; an LLR > 0 means bit 0.

The LDPC shift coefficients (``data/ldpc_base_graphs.npz``: ``bg1`` (8, 46,
68) and ``bg2`` (8, 42, 52), one plane per set of lifting sizes, -1 where
the base graph has no edge) are TS 38.212 Tables 5.3.2-2 and 5.3.2-3, a
byte-equal copy of the planes the program ships in its own table file;
``benchmark/tests/test_reference.py`` holds them against entries, edge
counts and structure written out from the specification.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path
from typing import Callable

import numpy as np
import torch

_TABLES = Path(__file__).resolve().parent / "data" / "ldpc_base_graphs.npz"

# TS 38.212 Table 5.3.2-1: the lifting sizes in their 8 sets
LIFTING_SETS = (
    (2, 4, 8, 16, 32, 64, 128, 256), (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320), (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288), (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208), (15, 30, 60, 120, 240),
)
# TS 38.214 Table 5.1.3.1-1: MCS index -> (Qm, R x 1024)
MCS_TABLE_1 = (
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
    (6, 948),
)
# TS 38.214 Table 5.1.3.2-1
TBS_TABLE = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
)
# TS 38.212 §5.1: (length, generator polynomial without the x^L term)
CRC24A = (24, 0x864CFB)
CRC24B = (24, 0x800063)
CRC16 = (16, 0x1021)
ALPHA = 0.8125          # the min-sum scale the configuration states
FILLER_LLR = 1e4        # a filler bit is a known 0


def tbs(qm: int, r1024: int, n_prb: int, n_symb: int, n_dmrs_re: int, n_layers: int) -> int:
    """TS 38.214 §5.1.3.2, no overhead."""
    n_re = min(156, 12 * n_symb - n_dmrs_re) * n_prb
    ninfo = n_re * r1024 / 1024 * qm * n_layers
    if ninfo <= 3824:
        n = max(3, math.floor(math.log2(ninfo)) - 6)
        npinfo = max(24, (int(ninfo) >> n) << n)
        return next(t for t in TBS_TABLE if t >= npinfo)
    n = math.floor(math.log2(ninfo - 24)) - 5
    npinfo = max(3840, round((ninfo - 24) / 2 ** n) * 2 ** n)
    if r1024 <= 256:
        c = math.ceil((npinfo + 24) / 3816)
    elif npinfo > 8424:
        c = math.ceil((npinfo + 24) / 8424)
    else:
        return 8 * math.ceil((npinfo + 24) / 8) - 24
    return 8 * c * math.ceil((npinfo + 24) / (8 * c)) - 24


@dataclasses.dataclass(frozen=True)
class Pusch:
    """One configuration, as the reference reads it from the benchmark's
    configuration file."""
    mu: int
    n_prb: int
    mcs: int
    n_layers: int
    n_symbols: int
    dmrs_symbols: tuple
    rnti: int
    n_id: int
    slot: int
    # the receiver's; a transmitter's file leaves them out
    n_rx: int = 0
    chest_window: int = 1
    n_iters: int = 0
    check_every: int = 0

    @classmethod
    def from_config(cls, c: dict) -> "Pusch":
        if c.get("mcs_table", 1) != 1 or not c["dmrs_symbols"] or c["n_layers"] > 2:
            raise ValueError("the reference covers MCS table 1, single-symbol DMRS, 1-2 layers")
        rx = {f: c[k] for f, k in (("n_rx", "n_rx"), ("chest_window", "chest_window"),
                                   ("n_iters", "n_iters"), ("check_every", "decoder_check_every"))
              if k in c}
        return cls(mu=c["mu"], n_prb=c["n_prb"], mcs=c["mcs"], n_layers=c["n_layers"],
                   n_symbols=c["n_symbols"], dmrs_symbols=tuple(sorted(c["dmrs_symbols"])),
                   rnti=c["rnti"], n_id=c["n_id"], slot=c["slot"], **rx)

    # --- numerology (TS 38.211 §4-5) ---
    @property
    def n_sc(self) -> int:
        return 12 * self.n_prb

    @property
    def fft(self) -> int:
        return next(n for n in (128, 256, 512, 1024, 1536, 2048, 3072, 4096, 6144, 8192)
                    if n > self.n_sc)

    def cp_lengths(self) -> list:
        """The CP of each symbol of the slot: long on symbols 0 and 7 * 2^mu
        of the subframe."""
        cp = self.fft * 144 // 2048
        first = (self.slot % (1 << self.mu)) * 14
        return [cp + (self.fft * (1 << self.mu) // 128 if (first + l) in (0, 7 << self.mu)
                      else 0) for l in range(14)]

    @property
    def samples(self) -> int:
        return sum(self.cp_lengths()) + 14 * self.fft

    @property
    def data_symbols(self) -> list:
        return [s for s in range(self.n_symbols) if s not in self.dmrs_symbols]

    # --- transport block (TS 38.212, 38.214) ---
    @property
    def qm(self) -> int:
        return MCS_TABLE_1[self.mcs][0]

    @property
    def r1024(self) -> int:
        return MCS_TABLE_1[self.mcs][1]

    @property
    def G(self) -> int:
        return len(self.data_symbols) * self.n_sc * self.qm * self.n_layers

    @property
    def A(self) -> int:
        return tbs(self.qm, self.r1024, self.n_prb, self.n_symbols,
                   12 * len(self.dmrs_symbols), self.n_layers)

    @functools.cached_property
    def seg(self) -> "Segments":
        return segments(self.A, self.r1024)

    @property
    def es(self) -> list:
        """Rate-matched length of each code block (TS 38.212 §5.4.2.1)."""
        C, lq = self.seg.C, self.n_layers * self.qm
        gp = self.G // lq
        return [lq * (gp // C) if j <= C - 1 - gp % C else lq * -(-gp // C) for j in range(C)]


@dataclasses.dataclass(frozen=True)
class Segments:
    bg: int
    C: int
    K_prime: int     # bits per code block with its CRC
    Z: int
    K: int           # kb * Z
    F: int           # filler bits
    tb_crc: tuple

    @property
    def payload(self) -> int:
        """Transport-block bits in one code block."""
        return self.K_prime - (24 if self.C > 1 else 0)


def segments(A: int, r1024: int) -> Segments:
    """TS 38.212 §6.2.1-6.2.3: CRC, base graph, code blocks, lifting size."""
    crc = CRC24A if A > 3824 else CRC16
    B = A + crc[0]
    bg = 2 if (A <= 292 or (A <= 3824 and r1024 <= 0.67 * 1024) or r1024 <= 256) else 1
    kcb = 8448 if bg == 1 else 3840
    C = 1 if B <= kcb else -(-B // (kcb - 24))
    K_prime = (B + (24 * C if C > 1 else 0)) // C
    kb = 22 if bg == 1 else (10 if B > 640 else 9 if B > 560 else 8 if B > 192 else 6)
    Z = min(z for s in LIFTING_SETS for z in s if kb * z >= K_prime)
    K = (22 if bg == 1 else 10) * Z
    return Segments(bg=bg, C=C, K_prime=K_prime, Z=Z, K=K, F=K - K_prime, tb_crc=crc)


# --------------------------------------------------------------------------
# CRC (TS 38.212 §5.1) as a product with a remainder matrix
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _crc_matrix_np(n_bits: int, crc: tuple) -> np.ndarray:
    """(n_bits, L): row i is x^(n_bits - 1 - i + L) mod g(x), MSB first."""
    L, poly = crc
    out = np.empty((n_bits, L), np.uint8)
    shifts = np.arange(L - 1, -1, -1)
    r = 1
    for _ in range(L):
        r = ((r << 1) & ((1 << L) - 1)) ^ (poly if r >> (L - 1) & 1 else 0)
    for i in range(n_bits - 1, -1, -1):
        out[i] = (r >> shifts) & 1
        r = ((r << 1) & ((1 << L) - 1)) ^ (poly if r >> (L - 1) & 1 else 0)
    return out


def crc(bits: torch.Tensor, spec: tuple) -> torch.Tensor:
    """(..., n) 0/1 -> (..., L) CRC bits, in float64 (every sum exact)."""
    m = torch.as_tensor(_crc_matrix_np(bits.shape[-1], spec), dtype=torch.float64,
                        device=bits.device)
    return ((bits.to(torch.float64) @ m).to(torch.int64) & 1).to(torch.int8)


# --------------------------------------------------------------------------
# Gold sequence (TS 38.211 §5.2.1)
# --------------------------------------------------------------------------

def gold(cinit: int, n: int) -> np.ndarray:
    """c(0..n-1) as int8.  x1(k+31) = x1(k+3) + x1(k); x2(k+31) = x2(k+3) +
    x2(k+2) + x2(k+1) + x2(k), both mod 2, from Nc = 1600; 28 new values of
    each depend only on values already known, so they come 28 at a time."""
    total = 1600 + n
    x1 = np.zeros(total + 31, np.int8)
    x2 = np.zeros(total + 31, np.int8)
    x1[0] = 1
    x2[:31] = (cinit >> np.arange(31)) & 1
    for k in range(0, total, 28):
        j = np.arange(k, min(k + 28, total))
        x1[j + 31] = x1[j + 3] ^ x1[j]
        x2[j + 31] = x2[j + 3] ^ x2[j + 2] ^ x2[j + 1] ^ x2[j]
    return (x1[1600:total] ^ x2[1600:total]).astype(np.int8)


def data_cinit(p: Pusch) -> int:
    """TS 38.211 §6.3.1.1, codeword 0."""
    return ((p.rnti << 15) + p.n_id) & 0xFFFFFFFF


def dmrs_pilots(p: Pusch, symbol: int) -> np.ndarray:
    """(6 n_prb,) complex64 DMRS sequence of a DMRS symbol (§6.4.1.1.1.1)."""
    cinit = ((1 << 17) * (14 * p.slot + symbol + 1) * (2 * p.n_id + 1)
             + 2 * p.n_id) % (1 << 31)
    c = gold(cinit, 12 * p.n_prb).astype(np.float32)
    return (((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)).astype(np.complex64)


def occ(layer: int) -> float:
    """The frequency OCC of a port's odd pilots (Table 6.4.1.1.3-1, ports 0, 1)."""
    return 1.0 if layer == 0 else -1.0


# --------------------------------------------------------------------------
# LDPC (TS 38.212 §5.3.2)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Graph:
    bg: int
    Z: int
    tab: np.ndarray          # (rows, cols) shift mod Z, -1: no edge

    @property
    def kc(self) -> int:
        return 22 if self.bg == 1 else 10

    @property
    def rows(self) -> int:
        return self.tab.shape[0]

    @property
    def cols(self) -> int:
        return self.tab.shape[1]

    @property
    def edges(self) -> int:
        return int((self.tab >= 0).sum())


@functools.lru_cache(maxsize=8)
def graph(bg: int, Z: int) -> Graph:
    ils = next(i for i, s in enumerate(LIFTING_SETS) if Z in s)
    tab = np.load(_TABLES)[f"bg{bg}"][ils].astype(np.int64)
    return Graph(bg, Z, np.where(tab >= 0, tab % Z, -1))


def _shift(block: torch.Tensor, s: int) -> torch.Tensor:
    """The Z-vector times the identity cyclically shifted right by s: out[k]
    = block[(k + s) mod Z]."""
    return torch.roll(block, -s, dims=-1)


def ldpc_encode(g: Graph, info: torch.Tensor) -> torch.Tensor:
    """(n, kc Z) 0/1 -> (n, cols Z) codewords with H c = 0.

    The four core rows summed leave only the first core parity column (its
    two unit shifts cancel but one), which gives p0; each remaining core row
    then has one unknown; each extension row r >= 4 holds its parity column
    kc + r alone, on the identity."""
    n, Z, kc, tab = info.shape[0], g.Z, g.kc, g.tab
    blocks = list(info.to(torch.uint8).reshape(n, kc, Z).unbind(1))

    def row_sum(r: int, upto: int) -> torch.Tensor:
        acc = torch.zeros((n, Z), dtype=torch.uint8, device=info.device)
        for j in range(upto):
            if tab[r, j] >= 0:
                acc ^= _shift(blocks[j], int(tab[r, j]))
        return acc

    s = [row_sum(r, kc) for r in range(4)]
    core = [int(tab[r, kc]) for r in range(4) if tab[r, kc] >= 0]
    alone = [v for v in core if core.count(v) % 2]
    if len(alone) != 1:
        raise ValueError(f"BG{g.bg}: core column does not reduce to one shift")
    p = {kc: _shift(s[0] ^ s[1] ^ s[2] ^ s[3], -alone[0])}
    todo = set(range(4))
    while len(p) < 4:
        r = next(r for r in sorted(todo)
                 if sum(tab[r, j] >= 0 and j not in p for j in range(kc, kc + 4)) == 1)
        j = next(j for j in range(kc, kc + 4) if tab[r, j] >= 0 and j not in p)
        acc = s[r]
        for jj in range(kc, kc + 4):
            if tab[r, jj] >= 0 and jj != j:
                acc = acc ^ _shift(p[jj], int(tab[r, jj]))
        p[j] = _shift(acc, -int(tab[r, j]))
        todo.discard(r)
    blocks += [p[j] for j in range(kc, kc + 4)]
    for r in range(4, g.rows):
        blocks.append(row_sum(r, kc + 4))
    return torch.stack(blocks, dim=1).reshape(n, g.cols * Z).to(torch.int8)


def syndrome_ok(g: Graph, bits: torch.Tensor) -> torch.Tensor:
    """(n, cols Z) 0/1 -> (n,) True where every parity check holds."""
    n = bits.shape[0]
    c = bits.to(torch.uint8).reshape(n, g.cols, g.Z)
    bad = torch.zeros((n,), dtype=torch.bool, device=bits.device)
    for r in range(g.rows):
        acc = torch.zeros((n, g.Z), dtype=torch.uint8, device=bits.device)
        for j in np.nonzero(g.tab[r] >= 0)[0]:
            acc ^= _shift(c[:, j], int(g.tab[r, j]))
        bad |= acc.bool().any(dim=1)
    return ~bad


@functools.lru_cache(maxsize=8)
def _row_index(bg: int, Z: int, device: torch.device):
    """Per row: its columns and the gather from column to row orientation
    (row lane k reads column lane (k + s) mod Z) and back."""
    g = graph(bg, Z)
    k = np.arange(Z)
    out = []
    for r in range(g.rows):
        js = np.nonzero(g.tab[r] >= 0)[0]
        s = g.tab[r, js][:, None]
        out.append((torch.as_tensor(js, device=device),
                    torch.as_tensor((k + s) % Z, device=device),
                    torch.as_tensor((k - s) % Z, device=device)))
    return out


def decode(g: Graph, llr: torch.Tensor, n_iters: int, check_every: int):
    """Layered normalized min-sum, rows in order, f32 messages:
    (n, cols Z) LLRs -> (bits (n, kc Z) int8, ok (n,), iterations (n,)).

    A code block whose syndrome is zero after a checked iteration keeps its
    totals and messages from then on and counts no more iterations."""
    n, Z = llr.shape[0], g.Z
    rows = _row_index(g.bg, Z, llr.device)
    tot = llr.to(torch.float32).reshape(n, g.cols, Z).clone()
    msg = [torch.zeros((n, len(js), Z), dtype=torch.float32, device=llr.device)
           for js, _, _ in rows]
    active = torch.ones((n,), dtype=torch.bool, device=llr.device)
    iters = torch.zeros((n,), dtype=torch.int32, device=llr.device)
    alpha = float(np.float32(ALPHA))
    for it in range(n_iters):
        iters += active
        keep_tot, keep_msg = tot.clone(), [m.clone() for m in msg]
        for ri, (js, fwd, back) in enumerate(rows):
            d = len(js)
            t = torch.gather(tot[:, js], -1, fwd.expand(n, d, Z))
            v = t - msg[ri]
            a = v.abs()
            m12 = torch.topk(a, 2, dim=1, largest=False).values
            mag = torch.where(a == m12[:, :1], m12[:, 1:], m12[:, :1]) * alpha
            neg = v < 0
            odd = (neg.sum(dim=1, keepdim=True) & 1).bool()
            new = torch.where(odd ^ neg, -mag, mag)
            tot[:, js] = torch.gather(t + (new - msg[ri]), -1, back.expand(n, d, Z))
            msg[ri] = new
        on = active[:, None, None]
        tot = torch.where(on, tot, keep_tot)
        msg = [torch.where(on, m, k) for m, k in zip(msg, keep_msg)]
        if check_every and it % check_every == check_every - 1:
            active &= ~syndrome_ok(g, (tot < 0).reshape(n, -1))
    hard = (tot < 0).reshape(n, -1)
    return hard[:, : g.kc * Z].to(torch.int8), syndrome_ok(g, hard), iters


# --------------------------------------------------------------------------
# Rate matching (TS 38.212 §5.4.2), rv 0, Ncb = N
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def selection(bg: int, Z: int, F: int, E: int) -> np.ndarray:
    """(E,) circular-buffer positions of the E selected bits (k0 = 0;
    the fillers skipped)."""
    kc, N = (22, 66 * Z) if bg == 1 else (10, 50 * Z)
    d = np.arange(N)
    lo = kc * Z - 2 * Z - F
    usable = d[(d < lo) | (d >= lo + F)]
    return np.resize(usable, E)


def rate_match(p: Pusch, cw: torch.Tensor) -> torch.Tensor:
    """(n, C, cols Z) codewords -> (n, G) interleaved codeword bits."""
    s, qm = p.seg, p.qm
    parts = []
    for j, E in enumerate(p.es):
        sel = torch.as_tensor(selection(s.bg, s.Z, s.F, E) + 2 * s.Z, device=cw.device)
        e = cw[:, j, sel]
        parts.append(e.reshape(-1, qm, E // qm).transpose(1, 2).reshape(-1, E))
    return torch.cat(parts, dim=1)


def recover(p: Pusch, llr_cw: torch.Tensor) -> torch.Tensor:
    """(n, G) codeword LLRs -> (n C, cols Z) decoder input: each block's
    bits deinterleaved and put back at their buffer positions (added where
    one is sent twice), 0 on the punctured head, FILLER_LLR on the fillers;
    then, as the configuration states, bfloat16."""
    s, qm, g = p.seg, p.qm, graph(p.seg.bg, p.seg.Z)
    n = llr_cw.shape[0]
    buf = torch.zeros((n, s.C, g.cols * s.Z), dtype=torch.float32, device=llr_cw.device)
    lo = g.kc * s.Z - s.F
    buf[:, :, lo: g.kc * s.Z] = FILLER_LLR
    off = 0
    for j, E in enumerate(p.es):
        f = llr_cw[:, off: off + E]
        e = f.reshape(n, E // qm, qm).transpose(1, 2).reshape(n, E)
        sel = torch.as_tensor(selection(s.bg, s.Z, s.F, E) + 2 * s.Z, device=llr_cw.device)
        buf[:, j].index_add_(1, sel, e)
        off += E
    return buf.reshape(n * s.C, -1).to(torch.bfloat16)


def desegment(p: Pusch, bits: torch.Tensor) -> tuple:
    """(n C, kc Z) decoded bits -> (transport blocks (n, A) int8, CRC ok (n,))."""
    s = p.seg
    tb = bits.reshape(-1, s.C, s.K)[:, :, : s.payload].reshape(-1, s.C * s.payload)
    L = s.tb_crc[0]
    ok = (crc(tb[:, :-L], s.tb_crc) == tb[:, -L:]).all(dim=1)
    return tb[:, :-L], ok


# --------------------------------------------------------------------------
# Transmitter (TS 38.211 §6.3.1, §6.4.1.1, §5.3; downlink §7.3.1, §7.4.1.1)
# --------------------------------------------------------------------------

def constellation(qm: int) -> np.ndarray:
    """(2^qm,) complex64, index = the bit group read MSB first (§5.1)."""
    b = (np.arange(1 << qm)[:, None] >> np.arange(qm - 1, -1, -1)) & 1
    s = 1 - 2 * b.astype(np.float64)
    if qm == 2:
        d = s[:, 0] + 1j * s[:, 1]
    elif qm == 4:
        d = s[:, 0] * (2 - s[:, 2]) + 1j * s[:, 1] * (2 - s[:, 3])
    elif qm == 6:
        d = (s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
             + 1j * s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5])))
    else:
        raise ValueError(f"Qm {qm}")
    return (d / np.sqrt(np.mean(np.abs(d) ** 2))).astype(np.complex64)


def codeword_bits(p: Pusch, tb: torch.Tensor) -> torch.Tensor:
    """(n, A) transport blocks -> (n, G) scrambled codeword bits: the CRCs,
    the code blocks, LDPC, rate matching and interleaving, scrambling."""
    s = p.seg
    n, dev = tb.shape[0], tb.device
    g = graph(s.bg, s.Z)
    b = torch.cat([tb, crc(tb, s.tb_crc)], dim=1).reshape(n, s.C, s.payload)
    if s.C > 1:
        b = torch.cat([b, crc(b, CRC24B)], dim=2)
    b = torch.cat([b, b.new_zeros((n, s.C, s.F))], dim=2)
    cw = ldpc_encode(g, b.reshape(n * s.C, s.K)).reshape(n, s.C, -1)
    bits = rate_match(p, cw)
    return bits ^ torch.as_tensor(gold(data_cinit(p), p.G), device=dev)


def slot_grid(p: Pusch, bits: torch.Tensor) -> torch.Tensor:
    """(n, G) scrambled codeword bits -> (n, layers, 14, n_sc) complex64 RE
    grid: QAM, layer mapping, the data symbols, the DMRS."""
    qm, L = p.qm, p.n_layers
    n, dev = bits.shape[0], bits.device
    groups = bits.reshape(n, -1, qm).to(torch.int64)
    idx = (groups << torch.arange(qm - 1, -1, -1, device=dev)).sum(-1)
    sym = torch.as_tensor(constellation(qm), device=dev)[idx]          # (n, G/qm)
    M = p.n_sc
    grid = torch.zeros((n, L, 14, M), dtype=torch.complex64, device=dev)
    grid[:, :, p.data_symbols] = sym.reshape(n, len(p.data_symbols), M, L).permute(0, 3, 1, 2)
    for s in p.dmrs_symbols:
        pil = dmrs_pilots(p, s)
        for lay in range(L):
            row = np.zeros(M, np.complex64)
            row[0::2] = pil * np.tile([1.0, occ(lay)], 3 * p.n_prb)
            grid[:, lay, s] = torch.as_tensor(row, device=dev)
    return grid


def transmit(p: Pusch, tb: torch.Tensor) -> torch.Tensor:
    """(n, A) transport blocks -> (n, layers, samples) complex64 slots."""
    return ofdm_modulate(p, slot_grid(p, codeword_bits(p, tb)))


def ofdm_modulate(p: Pusch, grid: torch.Tensor) -> torch.Tensor:
    """(..., 14, n_sc) -> (..., samples): subcarrier k on FFT bin
    (N - n_sc/2 + k) mod N, a unitary IFFT, each symbol's CP in front."""
    N, M = p.fft, p.n_sc
    bins = torch.zeros((*grid.shape[:-1], N), dtype=torch.complex64, device=grid.device)
    bins[..., (N - M // 2 + np.arange(M)) % N] = grid
    x = torch.fft.ifft(bins, dim=-1) * math.sqrt(N)
    return torch.cat([torch.cat([x[..., l, N - cp:], x[..., l, :]], dim=-1)
                      for l, cp in enumerate(p.cp_lengths())], dim=-1).to(torch.complex64)


# --------------------------------------------------------------------------
# Receiver frontend
# --------------------------------------------------------------------------

Quantize = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x with every real part rounded to bfloat16 (the control's precision)."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)


def ofdm_demodulate(p: Pusch, rx: torch.Tensor) -> torch.Tensor:
    """(..., samples) -> (..., 14, n_sc): CP dropped, unitary FFT."""
    N, M = p.fft, p.n_sc
    start, syms = 0, []
    for cp in p.cp_lengths():
        syms.append(rx[..., start + cp: start + cp + N])
        start += cp + N
    y = torch.fft.fft(torch.stack(syms, dim=-2), dim=-1) / math.sqrt(N)
    return y[..., (N - M // 2 + np.arange(M)) % N].to(torch.complex64)


def _moving_average(h: torch.Tensor, w: int) -> torch.Tensor:
    """Mean over w subcarriers, w // 2 before and w - 1 - w // 2 after,
    the edge values repeated beyond the band."""
    if w <= 1:
        return h
    lo, hi = w // 2, w - 1 - w // 2
    pad = torch.cat([h[..., :1].expand(*h.shape[:-1], lo), h,
                     h[..., -1:].expand(*h.shape[:-1], hi)], dim=-1)
    return pad.unfold(-1, w, 1).sum(-1) / w


def _interpolate(hp: torch.Tensor, M: int) -> torch.Tensor:
    """Comb 0 estimates (..., M/2) -> (..., M): each odd subcarrier the mean
    of its neighbours, the last one holds."""
    right = torch.cat([hp[..., 1:], hp[..., -1:]], dim=-1)
    return torch.stack([hp, 0.5 * (hp + right)], dim=-1).reshape(*hp.shape[:-1], M)


def frontend_llrs(p: Pusch, rx: torch.Tensor, q: Quantize = exact) -> torch.Tensor:
    """(n, rx, samples) -> (n, G) descrambled codeword LLRs."""
    n, M, L, qm = rx.shape[0], p.n_sc, p.n_layers, p.qm
    y = q(ofdm_demodulate(p, rx))                                     # (n, R, 14, M)
    ls_sym = [q(y[:, :, s, 0::2] * torch.as_tensor(dmrs_pilots(p, s), device=rx.device).conj())
              for s in p.dmrs_symbols]                                # each (n, R, M/2)
    ls = q(sum(ls_sym) / len(ls_sym))                                 # block fading
    if L == 1:
        h = q(_interpolate(q(_moving_average(ls, p.chest_window)), M))[:, :, None]
        nvar = None
    else:
        pairs = torch.stack([0.5 * (ls[..., 0::2] + occ(l) * ls[..., 1::2]) for l in range(L)],
                            dim=2)                                    # (n, R, L, M/4)
        d = pairs[..., 1:] - pairs[..., :-1]
        # the pairs average the DMRS symbols: scaled back to one symbol's
        nvar = q((d.abs() ** 2).mean(-1).mean((1, 2)) * len(ls_sym))  # (n,)
        sm = q(_moving_average(pairs.repeat_interleave(2, dim=-1), p.chest_window))
        h = q(_interpolate(sm, M))                                    # (n, R, L, M)
    yd = y[:, :, p.data_symbols]                                      # (n, R, S, M)
    hc = h.conj()[:, :, :, None]                                      # (n, R, L, 1, M)
    if L == 1:
        x = q((hc[:, :, 0] * yd).sum(1))[:, None]                     # (n, 1, S, M)
        mag = q((h.abs() ** 2).sum(1))[:, :, None]                    # (n, 1, 1, M)
    else:
        g00 = q((h[:, :, 0].abs() ** 2).sum(1))
        g11 = q((h[:, :, 1].abs() ** 2).sum(1))
        g01 = q((hc[:, :, 0, 0] * h[:, :, 1]).sum(1))
        x0 = q((hc[:, :, 0] * yd).sum(1))
        x1 = q((hc[:, :, 1] * yd).sum(1))
        a00, a11 = g00 + nvar[:, None], g11 + nvar[:, None]
        ag2 = g01.abs() ** 2
        inv = q(1.0 / (a00 * a11 - ag2))
        e0 = (a11[:, None] * x0 - g01[:, None] * x1) * inv[:, None]
        e1 = (a00[:, None] * x1 - g01.conj()[:, None] * x0) * inv[:, None]
        x = q(torch.stack([e0, e1], dim=1))                           # (n, 2, S, M)
        mag = q(torch.stack([(a11 * g00 - ag2) * inv, (a00 * g11 - ag2) * inv],
                            dim=1))[:, :, None]                       # (n, 2, 1, M)
    re, im, mag = x.real, x.imag, mag.expand(x.shape)
    if qm == 4:
        t = 2 / np.sqrt(10) * mag
        bits = [re, im, t - re.abs(), t - im.abs()]
    elif qm == 6:
        t4, t2 = 4 / np.sqrt(42) * mag, 2 / np.sqrt(42) * mag
        b2, b3 = t4 - re.abs(), t4 - im.abs()
        bits = [re, im, b2, b3, t2 - b2.abs(), t2 - b3.abs()]
    elif qm == 2:
        bits = [re / np.sqrt(2), im / np.sqrt(2)]
    else:
        raise ValueError(f"Qm {qm}")
    llr = q(torch.stack(bits, dim=-1).float())                        # (n, L, S, M, qm)
    llr = llr.permute(0, 2, 3, 1, 4).reshape(n, p.G)                  # (RE, layer, bit)
    c = torch.as_tensor(gold(data_cinit(p), p.G), device=rx.device).float()
    return llr * (1 - 2 * c)


def receive(p: Pusch, rx: torch.Tensor, q: Quantize = exact) -> dict:
    """The whole plain receiver over (n, rx, samples): LLRs, decoder input,
    decoded bits, flags and iterations."""
    llr = frontend_llrs(p, rx, q)
    g = graph(p.seg.bg, p.seg.Z)
    bits, ok, iters = decode(g, recover(p, llr), p.n_iters, p.check_every)
    tb, tb_ok = desegment(p, bits)
    C = p.seg.C
    return {"llrs": llr, "tb_bits": tb, "tb_ok": tb_ok, "cb_ok": ok.reshape(-1, C),
            "iters": iters.reshape(-1, C)}
