"""K1 and K2: the LDPC decoders' CUDA kernels and their plain versions.

Port of openairinterface5g_tpu/ops/ldpc_pallas.py::decode_pallas with every
variant it has: the row-layered or the flooding schedule, f32, int8 or bf16
messages, f32 or bf16 input, early stop every ``check_every`` iterations.
``decode`` prepares the input as decode_pallas does and, for a CUDA
tensor, launches

  * K1 (``_build_decoder``): ``csrc/ldpc_layered.cu`` for layered with f32
    or int8 messages (the main path), ``csrc/ldpc_flooding.cu`` for
    flooding with f32, int8 or bf16 messages;
  * K2 (``_build_decoder_bf16``), for bf16 messages under the layered
    schedule, as decode_pallas dispatches it: ``csrc/ldpc_layered.cu``
    with K2's arithmetic (signs from the sign bit, no early stop).

Both sources keep, per row and lane, a compressed check-node state instead
of messages, and take the rows in layers of orthogonal rows
(``layer_groups``) from one graph table (``_layered_tables``);
``csrc/ldpc_min_sum.cuh`` holds what they share.

For a CPU tensor it runs ``decode_plain``, the same schedules in PyTorch
with the same operation order and rounding, so kernel, plain version and
Pallas kernel give the same hard bits.

Early stop: with check_every > 0 each code block ends its decode after the
first checked iteration whose syndrome is zero.  The Pallas kernel stopped
groups of ``sb`` code blocks together; a converged code block that keeps
iterating there can only differ where min-sum leaves a valid codeword again.
K2 ignores ``check_every``, as ``_build_decoder_bf16`` does (it takes the
argument and never reads it): it always runs ``n_iters`` iterations.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..coding.ldpc import LDPCGraph, build_graph
from ..phy.llr import quantize
from . import _cuda

SCHEDULES = ("layered", "flooding")
_MSG_NAMES = {torch.float32: "f32", torch.int8: "int8", torch.bfloat16: "bf16"}
_MSG_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}   # csrc MsgKind
_K2_CODE = 3                                                        # csrc kMsgK2
# int32 words per (row, lane) of the kernels' check-node state: two
# magnitudes (f32, int8: 8 B; bf16: packed in 4 B) and the sign and d* word
_STATE_WORDS = {torch.float32: 3, torch.int8: 3, torch.bfloat16: 2}
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}   # csrc input type
_BF16_CLIP = 24.0        # ldpc_pallas.py:546, :563: bf16 totals stay near-exact

# one count per kernel, raised where ``decode`` launches it (CUDA tensors
# only); "layered_bf16" is K2, every other entry a variant of K1
KERNELS = ("layered_f32", "flooding_f32", "layered_int8", "flooding_int8",
           "flooding_bf16", "layered_bf16")
launches = dict.fromkeys(KERNELS, 0)


_KERNEL_NAMES = {(s, m): f"{s}_{n}" for s in SCHEDULES for m, n in _MSG_NAMES.items()}


def kernel_name(schedule: str, msg_dtype: torch.dtype) -> str:
    """The kernel ``decode`` runs for a variant: a key of ``launches``."""
    name = _KERNEL_NAMES.get((schedule, msg_dtype))
    if name is None:
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule {schedule!r}; have {SCHEDULES}")
        raise ValueError(f"msg_dtype {msg_dtype}; have {tuple(_MSG_NAMES)}")
    return name


def check_args(graph: LDPCGraph, shape, contiguous: bool, n_iters: int,
               check_every: int) -> None:
    """Raise ValueError unless the kernels take LLRs of this shape and layout
    for this graph: (B, cols*Z), contiguous, Z <= 384, counts >= 0."""
    if (len(shape) != 2 or shape[1] != graph.cols * graph.Z or not contiguous
            or graph.Z > 384 or n_iters < 0 or check_every < 0):
        raise ValueError(f"decode: llr shape {tuple(shape)} contiguous={contiguous}, need "
                         f"contiguous (B, {graph.cols * graph.Z}); Z={graph.Z} (at most "
                         f"384), n_iters={n_iters}, check_every={check_every} (not negative)")


def prepare_input(llr: torch.Tensor, msg_dtype: torch.dtype) -> torch.Tensor:
    """The decoder input of a variant (ldpc_pallas.py:546, :556-568): int8
    messages take LLRs quantized to [-127, 127] as int32; bf16 messages
    take LLRs clipped to +-24 in bf16; f32 messages take f32 or bf16 LLRs
    as given, any other type as f32."""
    if msg_dtype == torch.int8:
        return quantize(llr.float(), bits=8).to(torch.int32)
    if msg_dtype == torch.bfloat16:
        return llr.float().clamp(-_BF16_CLIP, _BF16_CLIP).to(torch.bfloat16)
    return llr if llr.dtype in (torch.float32, torch.bfloat16) else llr.float()


@functools.lru_cache(maxsize=32)
def _edges_np(bg: int, Z: int):
    """Edges in layer order: row_ptr (rows+1,), col (E,), shift (E,) int32.
    Within a row the columns ascend (ldpc_pallas.py::_edges)."""
    tab = build_graph(bg, Z).tab
    row_ptr, cols, shifts = [0], [], []
    for r in range(tab.shape[0]):
        js = np.nonzero(tab[r] >= 0)[0]
        cols.extend(js.tolist())
        shifts.extend((tab[r, js] % Z).tolist())
        row_ptr.append(len(cols))
    return (np.asarray(row_ptr, np.int32), np.asarray(cols, np.int32),
            np.asarray(shifts, np.int32))


@functools.lru_cache(maxsize=32)
def _col_edges_np(bg: int, Z: int):
    """Edges by column for decode_plain's flooding variable-node pass: col_ptr
    (cols+1,), col_edge (E,) int32.  Within a column the edges ascend, the
    order in which ldpc_pallas.py:242-245 adds the messages to a total."""
    _, col, _ = _edges_np(bg, Z)
    order = np.argsort(col, kind="stable")
    col_ptr = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=build_graph(bg, Z).cols))])
    return col_ptr.astype(np.int32), order.astype(np.int32)


@functools.lru_cache(maxsize=32)
def layer_groups(bg: int, Z: int) -> tuple:
    """The kernels' layers: ((first row, rows), ...), each a run of
    consecutive rows of which no two share a column, taken greedily in row
    order (BG1: 46 rows in 32 layers, BG2: 42 in 28, at every Z).  Rows of
    one layer update disjoint totals, so processing them between the same
    two barriers changes no bit: the layered kernel writes each total back,
    the flooding kernel adds each new message, layer by layer, so a column
    receives its rows' messages in ascending row order."""
    row_ptr, col, _ = _edges_np(bg, Z)
    groups, used = [], set()
    for r in range(len(row_ptr) - 1):
        cs = set(col[row_ptr[r]:row_ptr[r + 1]].tolist())
        if groups and not cs & used:
            groups[-1][1] += 1
            used |= cs
        else:
            groups.append([r, 1])
            used = cs
    return tuple(map(tuple, groups))


# the row degrees of the NR base graphs, each of which the kernels unroll
# exactly (csrc/ldpc_min_sum.cuh::row_update)
LAYERED_DEGREES = frozenset((3, 4, 5, 6, 7, 8, 9, 10, 19))


@functools.lru_cache(maxsize=32)
def _layered_tables(bg: int, Z: int, device: torch.device):
    """The kernels' graph table on the device (csrc/ldpc_min_sum.cuh):
    per layer first row | rows << 16, per row first edge | degree << 16,
    per edge col * Z | shift << 16, int32; its data pointer and the number
    of layers.  Raises ValueError for a row degree outside LAYERED_DEGREES."""
    row_ptr, col, shift = _edges_np(bg, Z)
    bad = set(np.diff(row_ptr).tolist()) - LAYERED_DEGREES
    if bad:
        raise ValueError(f"BG{bg} Z={Z}: row degrees {sorted(bad)} have no layered kernel case")
    layers = np.asarray([r | n << 16 for r, n in layer_groups(bg, Z)], np.int64)
    rows = row_ptr[:-1].astype(np.int64) | np.diff(row_ptr).astype(np.int64) << 16
    edges = col.astype(np.int64) * Z | shift.astype(np.int64) << 16
    t = torch.as_tensor(np.concatenate([layers, rows, edges]).astype(np.int32), device=device)
    return t, t.data_ptr(), len(layers)


@functools.lru_cache(maxsize=32)
def _round_bf16(x: float) -> float:
    """x rounded to bf16 (round to nearest even)."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


@functools.lru_cache(maxsize=32)
def _plain_tables(bg: int, Z: int, device: torch.device):
    """Per-row gather tables of the plain decoder, plus the edge-to-row map."""
    row_ptr, col, shift = _edges_np(bg, Z)
    k = np.arange(Z)
    rows = []
    for r in range(len(row_ptr) - 1):
        e0, e1 = int(row_ptr[r]), int(row_ptr[r + 1])
        s = shift[e0:e1, None]
        rows.append((e0, e1,
                     torch.as_tensor(col[e0:e1], dtype=torch.long, device=device),
                     torch.as_tensor((k + s) % Z, dtype=torch.long, device=device),
                     torch.as_tensor((k - s) % Z, dtype=torch.long, device=device)))
    edge_row = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    return rows, torch.as_tensor(edge_row, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=32)
def _vn_slots(bg: int, Z: int, device: torch.device):
    """The flooding variable-node pass as slots: slot j adds the j-th edge
    (in edge order) of every column that has one.  Per slot: columns (n,),
    edges (n,), and the (n, Z) gather index from check to variable
    orientation."""
    col_ptr, col_edge = _col_edges_np(bg, Z)
    _, _, shift = _edges_np(bg, Z)
    deg = np.diff(col_ptr)
    k = np.arange(Z)
    slots = []
    for j in range(int(deg.max())):
        cs = np.nonzero(deg > j)[0]
        es = col_edge[col_ptr[cs] + j]
        slots.append((torch.as_tensor(cs, dtype=torch.long, device=device),
                      torch.as_tensor(es, dtype=torch.long, device=device),
                      torch.as_tensor((k - shift[es, None]) % Z, dtype=torch.long, device=device)))
    return slots


def _parity_ok(neg: torch.Tensor, rows, edge_row: torch.Tensor) -> torch.Tensor:
    """(B,) True where every parity check of the (B, cols, Z) hard
    decisions `neg` (True = bit 1) holds."""
    B, _, Z = neg.shape
    hard = neg.to(torch.float32)
    per_edge = torch.cat(
        [torch.gather(hard[:, c], -1, idx.expand(B, -1, -1)) for (_, _, c, idx, _) in rows],
        dim=1)                                                   # (B, E, Z)
    syn = torch.zeros((B, len(rows), Z), dtype=torch.float32, device=neg.device)
    syn.index_add_(1, edge_row, per_edge)
    return torch.all((syn.to(torch.int32) & 1).reshape(B, -1) == 0, dim=1)


def _scale_fn(msg_dtype: torch.dtype, alpha: float):
    """The check-node magnitude scaling of a message type
    (ldpc_pallas.py:125-131): alpha in f32, alpha rounded to bf16 in bf16,
    13/16 with rounding in integers."""
    if msg_dtype == torch.int8:
        return lambda m: (m * 13 + 8) >> 4
    if msg_dtype == torch.bfloat16:
        alpha_bf = _round_bf16(alpha)
        return lambda m: m * alpha_bf
    alpha32 = float(np.float32(alpha))
    return lambda m: m * alpha32


_ACC = {torch.float32: torch.float32, torch.int8: torch.int32, torch.bfloat16: torch.bfloat16}


def decode_plain(graph: LDPCGraph, llr: torch.Tensor, n_iters: int = 8,
                 alpha: float = 0.8125, check_every: int = 0,
                 schedule: str = "layered", msg_dtype: torch.dtype = torch.float32,
                 return_iters: bool = False):
    """Normalized min-sum in PyTorch: (B, cols*Z) -> (bits (B, K) int8,
    ok (B,) bool), and with ``return_iters`` the (B,) int32 iterations each
    code block ran before its early stop.  The reference for both kernels:
    bf16 messages under the layered schedule go to ``decode_bf16_plain``
    (K2), every other variant runs here (K1).

    Totals and messages are kept in the accumulation type of the message
    type (f32, int32 or bf16; int8 messages as int32 values saturated to
    +-127), and every operation of ldpc_pallas.py:225-275 is one PyTorch
    operation in that type, so bf16 rounds where the Pallas kernel rounds.
    """
    kernel_name(schedule, msg_dtype)
    if msg_dtype == torch.bfloat16 and schedule == "layered":
        bits, ok = decode_bf16_plain(graph, llr, n_iters, alpha)
        iters = torch.full(ok.shape, n_iters, dtype=torch.int32, device=ok.device)
        return (bits, ok, iters) if return_iters else (bits, ok)
    g = graph
    x = prepare_input(llr, msg_dtype)
    B, Z = x.shape[0], g.Z
    dev = x.device
    rows, edge_row = _plain_tables(g.bg, Z, dev)
    E = int(edge_row.numel())
    acc = _ACC[msg_dtype]
    scale = _scale_fn(msg_dtype, alpha)
    x0 = x.reshape(B, g.cols, Z).to(acc)
    tot = x0.clone()
    c2v = torch.zeros((B, E, Z), dtype=acc, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    for it in range(n_iters):
        iters += active
        if check_every:
            prev_tot, prev_c2v = tot.clone(), c2v.clone()
        for (e0, e1, c, idx, inv) in rows:      # flooding: totals fixed in this pass
            deg = e1 - e0
            t = torch.gather(tot[:, c], -1, idx.expand(B, deg, Z))     # row view
            o = c2v[:, e0:e1]
            v = t - o
            a = v.abs()
            m12 = torch.topk(a, 2, dim=1, largest=False).values        # min1, min2
            m1, m2 = m12[:, :1], m12[:, 1:]
            neg = v < 0
            par = (neg.sum(dim=1, keepdim=True) & 1).bool()
            mag = scale(torch.where(a == m1, m2, m1))
            nv = torch.where(par ^ neg, -mag, mag)
            if msg_dtype == torch.int8:
                nv = nv.clamp(-127, 127)
            if schedule == "layered":
                upd = t + (nv - o)
                tot[:, c] = torch.gather(upd, -1, inv.expand(B, deg, Z))  # natural view
            c2v[:, e0:e1] = nv
        if schedule == "flooding":
            # variable-node pass: the LLR plus every message, added in edge
            # order per column (ldpc_pallas.py:240-245)
            tot = x0.clone()
            for cs, es, inv in _vn_slots(g.bg, Z, dev):
                contrib = torch.gather(c2v[:, es], -1, inv.expand(B, -1, -1))
                tot[:, cs] = tot[:, cs] + contrib
        if check_every:
            keep = active[:, None, None]
            tot = torch.where(keep, tot, prev_tot)
            c2v = torch.where(keep, c2v, prev_c2v)
            if it % check_every == check_every - 1:
                active = active & ~_parity_ok(tot < 0, rows, edge_row)
    bits = (tot[:, : g.kc] < 0).to(torch.int8).reshape(B, g.K)
    ok = _parity_ok(tot < 0, rows, edge_row)
    return (bits, ok, iters) if return_iters else (bits, ok)


def _sign_bit(x: torch.Tensor) -> torch.Tensor:
    """True where the bf16 sign bit is set (-0.0 included)."""
    return x.view(torch.int16) < 0


def decode_bf16_plain(graph: LDPCGraph, llr: torch.Tensor, n_iters: int = 8,
                      alpha: float = 0.8125):
    """K2's plain version: the bf16 sign-magnitude layered min-sum of
    ldpc_pallas.py:427-489 in PyTorch, (B, cols*Z) -> (bits, ok).

    Input clipped to +-24 in bf16; every operation rounds to bf16.  The
    sign of a value is its sign bit, so -0.0 counts as negative in the
    check-node sign and in the parity flag, while the hard bit is
    ``soft < 0``; the excluded minimum is min1/min2 (the same function as
    the prefix/suffix sweeps).  No early stop.
    """
    g = graph
    x = prepare_input(llr, torch.bfloat16)
    B, Z = x.shape[0], g.Z
    dev = x.device
    rows, edge_row = _plain_tables(g.bg, Z, dev)
    E = int(edge_row.numel())
    scale = _scale_fn(torch.bfloat16, alpha)
    tot = x.reshape(B, g.cols, Z).clone()
    c2v = torch.zeros((B, E, Z), dtype=torch.bfloat16, device=dev)
    for _ in range(n_iters):
        for (e0, e1, c, idx, inv) in rows:
            deg = e1 - e0
            t = torch.gather(tot[:, c], -1, idx.expand(B, deg, Z))
            o = c2v[:, e0:e1]
            v = t - o
            a = v.abs()
            m12 = torch.topk(a, 2, dim=1, largest=False).values
            m1, m2 = m12[:, :1], m12[:, 1:]
            sb = _sign_bit(v)
            par = (sb.sum(dim=1, keepdim=True) & 1).bool()
            mag = scale(torch.where(a == m1, m2, m1))
            val = torch.where(par ^ sb, -mag, mag)          # sign bit XOR onto +mag
            upd = t + (val - o)
            tot[:, c] = torch.gather(upd, -1, inv.expand(B, deg, Z))
            c2v[:, e0:e1] = val
    bits = (tot[:, : g.kc] < 0).to(torch.int8).reshape(B, g.K)
    return bits, _parity_ok(_sign_bit(tot), rows, edge_row)


def decode(graph: LDPCGraph, llr: torch.Tensor, n_iters: int = 8,
           alpha: float = 0.8125, schedule: str = "layered", sb: int | None = None,
           msg_dtype: torch.dtype = torch.float32, check_every: int = 0,
           return_iters: bool = False):
    """(B, cols*Z) LLRs -> (bits (B, K) int8, ok (B,) bool), with the
    signature of decode_pallas; with ``return_iters``, as in decode_plain,
    also the (B,) int32 iterations each code block ran.

    schedule 'layered' or 'flooding'; msg_dtype torch.float32, torch.int8
    or torch.bfloat16 (bf16 + layered is K2).  ``sb``, the number of code
    blocks a Pallas program held, is accepted for the same signature and
    has no effect: on the card every code block is one thread block.
    A CUDA tensor goes through the kernels, a CPU tensor through
    ``decode_plain``.
    """
    name = kernel_name(schedule, msg_dtype)
    if llr.is_cuda:
        return _launch(name, graph, llr, n_iters, alpha, msg_dtype, check_every, return_iters)
    if llr.device.type != "cpu":
        raise ValueError(f"decode: tensor on {llr.device}, not CUDA or CPU")
    return decode_plain(graph, llr, n_iters, alpha, check_every, schedule, msg_dtype,
                        return_iters)


def _launch(name: str, g: LDPCGraph, llr: torch.Tensor, n_iters: int, alpha: float,
            msg_dtype: torch.dtype, check_every: int, return_iters: bool = False):
    check_args(g, llr.shape, llr.is_contiguous(), n_iters, check_every)
    x = prepare_input(llr, msg_dtype).contiguous()
    B, dev, index = x.shape[0], x.device, x.get_device()
    table, table_ptr, n_layers = _layered_tables(g.bg, g.Z, dev)
    bits = torch.empty((B, g.K), dtype=torch.int8, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev) if return_iters else None
    # per (row, lane) the check-node state, never read before the kernel writes it
    state = torch.empty((_STATE_WORDS[msg_dtype] * B * g.rows * g.Z,), dtype=torch.int32,
                        device=dev)
    if msg_dtype is torch.bfloat16:      # bf16 paths scale by alpha in bf16
        alpha = _round_bf16(alpha)
    r = _cuda.route()
    entry = r.ldpc_flooding_decode if name.startswith("flooding") else r.ldpc_layered_decode
    rc = entry(x.data_ptr(), _IN_CODES[x.dtype],
               _K2_CODE if name == "layered_bf16" else _MSG_CODES[msg_dtype],
               bits.data_ptr(), ok.data_ptr(), iters.data_ptr() if return_iters else None,
               state.data_ptr(), table_ptr, B, n_layers, g.rows, g.cols,
               table.numel() - n_layers - g.rows, g.Z, g.K, n_iters, check_every, alpha,
               index, r.stream(index))
    if rc:
        raise _cuda.error(rc, f"ldpc decode ({name})")
    launches[name] += 1
    return (bits, ok, iters) if return_iters else (bits, ok)
