"""The designs of K1's flooding kernel and of K2 on the CPU.

No kernel runs here.  Both kernels (csrc/ldpc_flooding.cu, and K2 in
csrc/ldpc_layered.cu) keep no messages: per (row, lane) they keep the
compressed check-node state of the layered kernel (csrc/ldpc_min_sum.cuh).
These tests hold what their exactness rests on against the plain versions:
  * flooding, modelled in PyTorch: the totals of the last iteration stay
    fixed, every row's old messages come from its state, and each layer's
    rows (taken in reverse order) add their new messages into a second
    buffer that starts from the LLRs, layer after layer, so every column
    receives its rows' messages in ascending row order.  The model equals
    ``decode_plain(schedule="flooding")`` in bits, flags and iteration
    counts, for f32, int8 and bf16 messages, with early stop;
  * K2's state: the sign of a value is its sign bit, so the state's sign
    word gives back every message of K2's update, -0.0 and ties in |v|
    included; and a model of K2 on that state (layers, bf16 totals, no
    early stop) equals ``decode_bf16_plain``;
  * the state's packed bf16 magnitudes (two in one 32-bit word) lose
    nothing.
"""
import numpy as np
import pytest
import torch

from openairinterface5g_tpu_torch.coding import ldpc
from openairinterface5g_tpu_torch.ops import ldpc_decoder
from test_torch_cuda import _awgn_llr
from test_torch_ldpc_layered import ALPHA, _CASES, _bits, _compress, _expand, _scale

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

# (n_iters, check_every): no early stop, and a check after every first and
# third iteration
RUNS = [(1, 0), (5, 0), (5, 1), (6, 3)]


def _flooding_state_decode(g, llr, n_iters, check_every, msg_dtype):
    """The flooding kernel's schedule in PyTorch -> (bits, ok, iters)."""
    x = ldpc_decoder.prepare_input(llr, msg_dtype)
    B, Z = x.shape[0], g.Z
    rows, edge_row = ldpc_decoder._plain_tables(g.bg, Z, x.device)
    acc = ldpc_decoder._ACC[msg_dtype]
    x0 = x.reshape(B, g.cols, Z).to(acc)
    cur = x0.clone()
    state = [None] * len(rows)
    active = torch.ones((B,), dtype=torch.bool)
    iters = torch.zeros((B,), dtype=torch.int32)
    for it in range(n_iters):
        iters += active
        prev_cur, prev_state = cur, list(state)
        nxt = x0.clone()                              # the LLRs, read again
        for r0, n in ldpc_decoder.layer_groups(g.bg, Z):
            for r in reversed(range(r0, r0 + n)):
                e0, e1, c, idx, inv = rows[r]
                deg = e1 - e0
                t = torch.gather(cur[:, c], -1, idx.expand(B, deg, Z))     # fixed totals
                v = t if it == 0 else t - _expand(state[r], deg)
                state[r] = _compress(v, msg_dtype)
                nv = torch.gather(_expand(state[r], deg), -1, inv.expand(B, deg, Z))
                nxt[:, c] = nxt[:, c] + nv
        keep = active[:, None, None]
        cur = torch.where(keep, nxt, prev_cur)
        if it > 0:
            state = [tuple(torch.where(keep, a, b) for a, b in zip(s, p))
                     for s, p in zip(state, prev_state)]
        if check_every and it % check_every == check_every - 1:
            active = active & ~ldpc_decoder._parity_ok(cur < 0, rows, edge_row)
    bits = (cur[:, : g.kc] < 0).to(torch.int8).reshape(B, g.K)
    return bits, ldpc_decoder._parity_ok(cur < 0, rows, edge_row), iters


@pytest.mark.parametrize("bg,Z", [(2, 16), (1, 8)])
@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("case", ["awgn", "ties", "zeros"])
def test_flooding_state_schedule_equals_plain(bg, Z, msg_dtype, case):
    g = ldpc.build_graph(bg, Z)
    _, llr = _awgn_llr(g, 6, seed=bg * Z + 1, snr_db=(0.5, 3.0), case=case)
    llr = torch.as_tensor(llr)
    stops = set()
    for n_iters, check_every in RUNS:
        want = ldpc_decoder.decode_plain(g, llr, n_iters, ALPHA, check_every,
                                         schedule="flooding", msg_dtype=msg_dtype,
                                         return_iters=True)
        got = _flooding_state_decode(g, llr, n_iters, check_every, msg_dtype)
        for w, h in zip(want, got):
            assert torch.equal(w, h), (n_iters, check_every)
        if check_every:
            stops |= set(want[2].tolist())
    assert len(stops) > 1 or case != "awgn"          # blocks stop at different iterations


def test_flooding_additions_follow_row_order():
    """Layer by layer, every column receives its rows' messages in
    ascending row order, one row per layer: the order of decode_plain's
    variable-node pass (the j-th edge of a column, in edge order)."""
    for bg in (1, 2):
        row_ptr, col, _ = ldpc_decoder._edges_np(bg, 8)
        col_ptr, col_edge = ldpc_decoder._col_edges_np(bg, 8)
        edge_row = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
        order = {c: [] for c in range(len(col_ptr) - 1)}
        for li, (r0, n) in enumerate(ldpc_decoder.layer_groups(bg, 8)):
            for r in range(r0, r0 + n):
                for c in col[row_ptr[r]:row_ptr[r + 1]]:
                    order[int(c)].append((li, r))
        for c, seen in order.items():
            layers = [li for li, _ in seen]
            assert layers == sorted(set(layers))          # one row per layer, in order
            assert [r for _, r in seen] == edge_row[col_edge[col_ptr[c]:col_ptr[c + 1]]].tolist()


# --------------------------------------------------------------------------
# K2: signs from the sign bit
# --------------------------------------------------------------------------

def _k2_messages(v):
    """decode_bf16_plain's check-node update of one row: v (B, deg, Z)
    bf16 -> the new messages (ops/ldpc_decoder.py::decode_bf16_plain)."""
    a = v.abs()
    m12 = torch.topk(a, 2, dim=1, largest=False).values
    m1, m2 = m12[:, :1], m12[:, 1:]
    sb = ldpc_decoder._sign_bit(v)
    par = (sb.sum(dim=1, keepdim=True) & 1).bool()
    mag = _scale(torch.bfloat16)(torch.where(a == m1, m2, m1))
    return torch.where(par ^ sb, -mag, mag)


def _compress_k2(v):
    """K2's state of one row: as _compress, with each sign the sign bit."""
    s1, s2, dstar, _ = _compress(v, torch.bfloat16)
    sb = ldpc_decoder._sign_bit(v)
    par = (sb.sum(dim=1, keepdim=True) & 1).bool()
    return s1, s2, dstar, par ^ sb


def _bf16_bits(x):
    return x.view(torch.int16)


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("deg", [3, 10, 19])
def test_state_gives_back_k2_messages(case, deg):
    rng = np.random.default_rng(deg + 2)
    v = torch.as_tensor(_CASES[case](rng, (64, deg, 16))).to(torch.bfloat16)
    if case == "all zero":           # -0.0 in some rows: they count as negative
        v[::3, 0] = -0.0
    want = _k2_messages(v)
    got = _expand(_compress_k2(v), deg)
    assert torch.equal(_bf16_bits(got), _bf16_bits(want))
    if case in ("signed zeros", "all zero"):
        neg_zero = _bf16_bits(torch.tensor(-0.0, dtype=torch.bfloat16))
        assert bool((_bf16_bits(want) == neg_zero).any())
    # the sign of -0.0 is not `< 0`: K1's state would give other messages
    if case == "signed zeros":
        k1 = _expand(_compress(v, torch.bfloat16), deg)
        assert not torch.equal(_bf16_bits(k1), _bf16_bits(want))


def _k2_state_decode(g, llr, n_iters):
    """K2 on the layered kernel in PyTorch: layers (rows in reverse order),
    compressed state with sign-bit signs, bf16 totals, no state read in the
    first iteration, no early stop -> (bits, ok)."""
    x = ldpc_decoder.prepare_input(llr, torch.bfloat16)
    B, Z = x.shape[0], g.Z
    rows, edge_row = ldpc_decoder._plain_tables(g.bg, Z, x.device)
    tot = x.reshape(B, g.cols, Z).clone()
    state = [None] * len(rows)
    for it in range(n_iters):
        for r0, n in ldpc_decoder.layer_groups(g.bg, Z):
            for r in reversed(range(r0, r0 + n)):
                e0, e1, c, idx, inv = rows[r]
                deg = e1 - e0
                t = torch.gather(tot[:, c], -1, idx.expand(B, deg, Z))
                o = None if it == 0 else _expand(state[r], deg)
                state[r] = _compress_k2(t if o is None else t - o)
                new = _expand(state[r], deg)
                upd = t + new if o is None else t + (new - o)
                tot[:, c] = torch.gather(upd, -1, inv.expand(B, deg, Z))
    bits = (tot[:, : g.kc] < 0).to(torch.int8).reshape(B, g.K)
    return bits, ldpc_decoder._parity_ok(ldpc_decoder._sign_bit(tot), rows, edge_row)


@pytest.mark.parametrize("bg,Z", [(2, 16), (1, 8)])
@pytest.mark.parametrize("case", ["awgn", "ties", "zeros", "all zero"])
def test_k2_state_schedule_equals_plain(bg, Z, case):
    g = ldpc.build_graph(bg, Z)
    _, llr = _awgn_llr(g, 6, seed=bg * Z + 2, snr_db=(0.0, 3.0), case=case)
    llr = torch.as_tensor(llr)
    if case == "all zero":
        llr[1, 3] = -0.0             # a -0.0 total: bit 0, yet its parity fails
    for n_iters in (0, 1, 5):
        want = ldpc_decoder.decode_bf16_plain(g, llr, n_iters, ALPHA)
        got = _k2_state_decode(g, llr, n_iters)
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1]), n_iters
        if case == "all zero" and n_iters == 0:
            assert not bool(want[1][1]) and bool(want[1][0])


# --------------------------------------------------------------------------
# what the state is kept in
# --------------------------------------------------------------------------

def test_packed_bf16_magnitudes_are_exact():
    """csrc/ldpc_arith.cuh Arith<kMsgBF16>::pack/unpack in numpy: a bf16
    value is the high half of its f32 bits, so two magnitudes (>= +0.0)
    share one word and come back bit for bit."""
    rng = np.random.default_rng(5)
    mags = torch.as_tensor(np.abs(rng.standard_normal(4096)).astype(np.float32) * 30)
    mags[:3] = torch.tensor([0.0, 3e38, 1e-38])
    s = mags.to(torch.bfloat16).float().numpy().view(np.uint32)
    s1, s2 = s[: len(s) // 2], s[len(s) // 2:]
    word = (s1 >> 16) | (s2 & 0xFFFF0000)
    np.testing.assert_array_equal((word << 16).astype(np.uint32), s1)
    np.testing.assert_array_equal(word & 0xFFFF0000, s2)
