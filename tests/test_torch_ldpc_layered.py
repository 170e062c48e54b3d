"""The design of K1's layered kernel (csrc/ldpc_layered.cu) on the CPU.

No kernel runs here.  These tests hold the facts the kernel's exactness
rests on against ``decode_plain``'s arithmetic:
  * the layers of ``ldpc_decoder.layer_groups``: consecutive rows of which
    no two share a column, 32 layers in BG1 and 28 in BG2 at every Z, and
    the graph table the kernel reads them from;
  * the packed syndrome check (signs 32 lanes to a word, a funnel shift per
    edge), modelled in numpy, against the walk over each row's edges;
  * the compressed check-node state: from (scale(m1), scale(m2), d*, the
    outgoing signs) a test-local reconstruction gives back every message
    decode_plain's arithmetic makes, bit for bit (ties in |v|, -0.0,
    all-zero LLRs, int8 saturation);
and a test-local PyTorch model of the kernel's schedule (layers, state
instead of messages, no state read in the first iteration, rows of a layer
taken in reverse order) decodes to decode_plain's bits, flags and
iteration counts.
"""
import numpy as np
import pytest
import torch

from openairinterface5g_tpu_torch.coding import ldpc
from openairinterface5g_tpu_torch.ops import ldpc_decoder
from test_torch_cuda import _awgn_llr

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ALPHA = 0.8125


def _scale(msg_dtype):
    return ldpc_decoder._scale_fn(msg_dtype, ALPHA)


def _sat(x, msg_dtype):
    return x.clamp(-127, 127) if msg_dtype == torch.int8 else x


# --------------------------------------------------------------------------
# the layers and the graph table
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bg,Z,n_layers", [(1, 2, 32), (1, 104, 32), (1, 384, 32),
                                           (2, 2, 28), (2, 64, 28), (2, 384, 28)])
def test_layer_groups(bg, Z, n_layers):
    g = ldpc.build_graph(bg, Z)
    groups = ldpc_decoder.layer_groups(bg, Z)
    assert len(groups) == n_layers
    # the groups cover the rows in order, each once
    assert [r for r0, n in groups for r in range(r0, r0 + n)] == list(range(g.rows))
    assert max(n for _, n in groups) <= 3            # kMaxRows of the kernel
    for r0, n in groups:
        cols = [set(np.nonzero(g.tab[r] >= 0)[0].tolist()) for r in range(r0, r0 + n)]
        for i in range(n):
            for j in range(i + 1, n):
                assert not cols[i] & cols[j], (r0 + i, r0 + j)


@pytest.mark.parametrize("bg,Z", [(1, 384), (2, 104)])
def test_layered_tables(bg, Z):
    g = ldpc.build_graph(bg, Z)
    table, _, n_layers = ldpc_decoder._layered_tables(bg, Z, torch.device("cpu"))
    t = table.numpy()
    E = int(g.evalid.sum())
    assert t.shape == (n_layers + g.rows + E,) and t.dtype == np.int32
    lay, rows, edges = t[:n_layers], t[n_layers:n_layers + g.rows], t[n_layers + g.rows:]
    assert [(x & 0xFFFF, x >> 16) for x in lay] == list(ldpc_decoder.layer_groups(bg, Z))
    e = 0
    for r in range(g.rows):
        js = np.nonzero(g.tab[r] >= 0)[0]
        assert (rows[r] & 0xFFFF, rows[r] >> 16) == (e, len(js))
        for j in js:
            assert (edges[e] & 0xFFFF, edges[e] >> 16) == (j * Z, g.tab[r, j] % Z)
            e += 1
    assert e == E
    assert set(np.diff(np.append(rows & 0xFFFF, E)).tolist()) <= ldpc_decoder.LAYERED_DEGREES


def test_layered_tables_reject_other_degrees(monkeypatch):
    """A row degree the kernel has no case for is refused on the host."""
    row_ptr, col, shift = ldpc_decoder._edges_np(2, 16)
    row_ptr = row_ptr.copy()
    row_ptr[1:] += 11 - (row_ptr[1] - row_ptr[0])     # row 0 of degree 11
    monkeypatch.setattr(ldpc_decoder, "_edges_np", lambda bg, Z: (row_ptr, col, shift))
    with pytest.raises(ValueError, match=r"\[11\]"):
        ldpc_decoder._layered_tables.__wrapped__(2, 16, torch.device("cpu"))


def _packed_syndrome(hard, table, n_layers, rows, Z):
    """csrc/ldpc_layered.cu::any_check_fails_packed in numpy: per row the
    32-lane words of the syndrome, from the hard decisions (cols, Z) packed
    32 lanes to a word and one cyclic funnel shift per edge."""
    nw = Z // 32
    flat = [int(sum(int(hard[c, 32 * w + j]) << j for j in range(32)))
            for c in range(hard.shape[0]) for w in range(nw)]
    rtab, etab = table[n_layers:n_layers + rows], table[n_layers + rows:]
    syn = np.zeros((rows, Z), bool)
    for r in range(rows):
        e0, deg = int(rtab[r]) & 0xFFFF, int(rtab[r]) >> 16
        for wr in range(nw):
            x = 0
            for ent in etab[e0:e0 + deg]:
                p = 32 * wr + (int(ent) >> 16)
                p -= Z if p >= Z else 0
                col, i = (int(ent) & 0xFFFF) >> 5, p >> 5
                lo, hi = flat[col + i], flat[col + (0 if i + 1 == nw else i + 1)]
                x ^= ((hi << 32 | lo) >> (p & 31)) & 0xFFFFFFFF
            syn[r, 32 * wr:32 * wr + 32] = [(x >> j) & 1 for j in range(32)]
    return syn


@pytest.mark.parametrize("bg,Z", [(1, 384), (1, 32), (2, 64), (2, 96)])
def test_packed_syndrome_check(bg, Z):
    """The packed check's syndrome equals the walk over each row's edges,
    lane by lane: for a codeword, and with bits flipped."""
    g = ldpc.build_graph(bg, Z)
    table, _, n_layers = ldpc_decoder._layered_tables(bg, Z, torch.device("cpu"))
    rng = np.random.default_rng(Z)
    info = rng.integers(0, 2, (1, g.K)).astype(np.int8)
    cw = ldpc.encode(g, torch.as_tensor(info)).numpy()[0].reshape(g.cols, Z).astype(bool)
    for flips in (0, 1, 7):
        hard = cw.copy()
        for _ in range(flips):
            hard[rng.integers(g.cols), rng.integers(Z)] ^= True
        walk = np.zeros((g.rows, Z), bool)
        for r in range(g.rows):
            for j in np.nonzero(g.tab[r] >= 0)[0]:
                walk[r] ^= np.roll(hard[j], -(g.tab[r, j] % Z))
        assert walk.any() == (flips > 0)
        np.testing.assert_array_equal(_packed_syndrome(hard, table.numpy(), n_layers,
                                                       g.rows, Z), walk)


# --------------------------------------------------------------------------
# the compressed state
# --------------------------------------------------------------------------

def _plain_messages(v, msg_dtype):
    """decode_plain's check-node update of one row: v (B, deg, Z) -> the
    new messages (ops/ldpc_decoder.py::decode_plain)."""
    a = v.abs()
    m12 = torch.topk(a, 2, dim=1, largest=False).values
    m1, m2 = m12[:, :1], m12[:, 1:]
    neg = v < 0
    par = (neg.sum(dim=1, keepdim=True) & 1).bool()
    mag = _scale(msg_dtype)(torch.where(a == m1, m2, m1))
    return _sat(torch.where(par ^ neg, -mag, mag), msg_dtype)


def _compress(v, msg_dtype):
    """The kernel's state of one row: (s1, s2, d*, outgoing signs), with d*
    the first edge whose |v| equals m1, as the kernel picks it."""
    a = v.abs()
    m12 = torch.topk(a, 2, dim=1, largest=False).values
    m1, m2 = m12[:, :1], m12[:, 1:]
    deg = v.shape[1]
    d = torch.arange(deg).view(1, deg, 1)
    dstar = torch.where(a == m1, d, deg).amin(dim=1, keepdim=True)
    neg = v < 0
    par = (neg.sum(dim=1, keepdim=True) & 1).bool()
    scale = _scale(msg_dtype)
    return (_sat(scale(m1), msg_dtype), _sat(scale(m2), msg_dtype), dstar, par ^ neg)


def _expand(state, deg):
    """Every message of a row from its state: ±(d == d* ? s2 : s1)."""
    s1, s2, dstar, sgn = state
    d = torch.arange(deg).view(1, deg, 1)
    mag = torch.where(d == dstar, s2, s1)
    return torch.where(sgn, -mag, mag)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


_CASES = {
    "random": lambda rng, s: rng.standard_normal(s).astype(np.float32) * 4,
    # few values: |v| ties at m1 and m2, equal signs and magnitudes
    "ties": lambda rng, s: rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], s).astype(np.float32),
    # zeros of both signs: the messages' -0.0
    "signed zeros": lambda rng, s: rng.choice([-0.0, 0.0, 0.0, 1.5, -1.5], s).astype(np.float32),
    "all zero": lambda rng, s: np.zeros(s, np.float32),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("deg", [3, 10, 19])
def test_state_gives_back_f32_messages(case, deg):
    rng = np.random.default_rng(deg)
    v = torch.as_tensor(_CASES[case](rng, (64, deg, 16)))
    want = _plain_messages(v, torch.float32)
    got = _expand(_compress(v, torch.float32), deg)
    assert torch.equal(_bits(got), _bits(want))
    if case == "signed zeros":
        assert bool((_bits(want) == _bits(torch.tensor(-0.0))).any())   # -0.0 occurs


@pytest.mark.parametrize("case", ["random", "ties", "all zero", "saturated"])
@pytest.mark.parametrize("deg", [3, 10, 19])
def test_state_gives_back_int8_messages(case, deg):
    rng = np.random.default_rng(deg + 1)
    shape = (64, deg, 16)
    if case == "saturated":     # |v| up to int32 totals of +-127 LLRs plus 30 messages
        v = rng.integers(-4000, 4000, shape)
    elif case == "ties":
        v = rng.choice([-130, -3, 3, 130, 160], shape)
    else:
        v = np.rint(_CASES[case](rng, shape) * 8)
    v = torch.as_tensor(v.astype(np.int32))
    want = _plain_messages(v, torch.int8)
    state = _compress(v, torch.int8)
    assert torch.equal(_expand(state, deg), want)
    assert int(state[0].max()) <= 127 and int(state[1].max()) <= 127   # fits the state
    if case == "saturated":
        assert bool((want.abs() == 127).any())


# --------------------------------------------------------------------------
# the kernel's schedule, modelled in PyTorch
# --------------------------------------------------------------------------

def _layered_state_decode(g, llr, n_iters, check_every, msg_dtype):
    """The kernel's schedule in PyTorch: layers of orthogonal rows (each
    layer's rows in reverse order), compressed state, no state read in the
    first iteration, per-code-block early stop.  -> (bits, ok, iters)."""
    x = ldpc_decoder.prepare_input(llr, msg_dtype)
    B, Z = x.shape[0], g.Z
    rows, edge_row = ldpc_decoder._plain_tables(g.bg, Z, x.device)
    acc = ldpc_decoder._ACC[msg_dtype]
    tot = x.reshape(B, g.cols, Z).to(acc).clone()
    state = [None] * len(rows)
    active = torch.ones((B,), dtype=torch.bool)
    iters = torch.zeros((B,), dtype=torch.int32)
    for it in range(n_iters):
        iters += active
        prev_tot, prev_state = tot.clone(), list(state)
        for r0, n in ldpc_decoder.layer_groups(g.bg, Z):
            for r in reversed(range(r0, r0 + n)):
                e0, e1, c, idx, inv = rows[r]
                deg = e1 - e0
                t = torch.gather(tot[:, c], -1, idx.expand(B, deg, Z))
                if it == 0:
                    v = t
                    state[r] = _compress(v, msg_dtype)
                    upd = t + _expand(state[r], deg)
                else:
                    o = _expand(state[r], deg)
                    v = t - o
                    state[r] = _compress(v, msg_dtype)
                    upd = t + (_expand(state[r], deg) - o)
                tot[:, c] = torch.gather(upd, -1, inv.expand(B, deg, Z))
        keep = active[:, None, None]
        tot = torch.where(keep, tot, prev_tot)
        if it > 0:
            state = [tuple(torch.where(keep, a, b) for a, b in zip(s, p))
                     for s, p in zip(state, prev_state)]
        if check_every and it % check_every == check_every - 1:
            active = active & ~ldpc_decoder._parity_ok(tot < 0, rows, edge_row)
    bits = (tot[:, : g.kc] < 0).to(torch.int8).reshape(B, g.K)
    return bits, ldpc_decoder._parity_ok(tot < 0, rows, edge_row), iters


@pytest.mark.parametrize("bg,Z", [(2, 16), (1, 8)])
@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("case", ["awgn", "ties", "zeros"])
def test_state_schedule_equals_plain(bg, Z, msg_dtype, case):
    g = ldpc.build_graph(bg, Z)
    _, llr = _awgn_llr(g, 8, seed=bg * Z, snr_db=1.5, case=case)
    llr = torch.as_tensor(llr)
    for n_iters, check_every in [(1, 0), (1, 1), (5, 0), (5, 1), (5, 2), (6, 3)]:
        want = ldpc_decoder.decode_plain(g, llr, n_iters, ALPHA, check_every,
                                         msg_dtype=msg_dtype, return_iters=True)
        got = _layered_state_decode(g, llr, n_iters, check_every, msg_dtype)
        for w, h in zip(want, got):
            assert torch.equal(w, h), (n_iters, check_every)
