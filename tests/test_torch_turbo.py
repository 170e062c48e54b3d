"""The port's LTE turbo codec (coding/turbo.py) and its copy of the QPP
table against the JAX package's, on the CPU.

Tolerances: the QPP table and permutations, the trellis tables, the
encoder's three streams and the decoded bits equal; one add-compare-select
step equal to JAX's scatter-max bit for bit; SISO extrinsics and decoder
LLRs within 1e-3 of their largest magnitude.  The JAX decoder compiles a
lax.scan per K, so the decoder cases use few K: 40, 512 and 3200; the
JAX encoder and decoder are compiled by XLA at its CPU optimization level
0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.coding import turbo as jturbo
from openairinterface5g_tpu.data import lte_tables as jlte
from openairinterface5g_tpu_torch.coding import turbo as tturbo
from openairinterface5g_tpu_torch.data import lte_tables as tlte

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

LLR_TOL = 1e-3      # SISO extrinsics and decoder LLRs: of the largest magnitude


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _stream_llrs(K: int, B: int, snr_db: float, seed: int):
    """Sent bits (B, K) and the LLRs of their three encoded streams over
    BPSK + AWGN at snr_db, numpy float32."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, K)).astype(np.int8)
    d = [np.asarray(x) for x in _compiled(jturbo.encode, jnp.asarray(bits))]
    sigma = 10 ** (-snr_db / 20)
    llrs = [(2 / sigma ** 2 * ((1 - 2 * x.astype(np.float32))
                               + sigma * rng.standard_normal(x.shape))).astype(np.float32)
            for x in d]
    return bits, llrs


def test_qpp_table_copy_matches_jax():
    assert tlte.QPP_F1F2 == jlte.QPP_F1F2
    assert tlte.QPP_BY_K == jlte.QPP_BY_K
    assert tlte.LTE_K_SIZES == jlte.LTE_K_SIZES and len(tlte.LTE_K_SIZES) == 188


def test_qpp_interleaver_and_tables_match_jax():
    for K in tlte.LTE_K_SIZES:
        got = tturbo.qpp_interleaver(K)
        np.testing.assert_array_equal(got, jturbo.qpp_interleaver(K))
        assert got.dtype == np.int32
        assert np.array_equal(np.sort(got), np.arange(K))
    for a, b in zip(tturbo._tables(), jturbo._tables()):
        np.testing.assert_array_equal(a, b)


def test_rsc_linear_form():
    """The state period is 7 (g0 primitive), and the termination table is
    JAX's _rsc_terminate from each of the 8 states."""
    P, _, tail = tturbo._rsc_linear()
    assert P == 7
    xs, zs = jturbo._rsc_terminate(jnp.arange(8, dtype=jnp.int32))
    np.testing.assert_array_equal(tail[:, :3], np.asarray(xs))
    np.testing.assert_array_equal(tail[:, 3:], np.asarray(zs))


@pytest.mark.parametrize("K", [40, 512, 1008, 3200, 6144])
def test_encode_matches_jax(K):
    """d0, d1, d2 bit-equal to JAX's lax.scan encoder (batch 3, with an
    all-ones and an all-zero block)."""
    rng = np.random.default_rng(K)
    bits = rng.integers(0, 2, (3, K)).astype(np.int8)
    bits[1] = 1
    bits[2] = 0
    for got, want in zip(tturbo.encode(torch.as_tensor(bits)),
                         _compiled(jturbo.encode, jnp.asarray(bits))):
        assert got.dtype == torch.int8 and got.shape == (3, K + 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trellis_step_matches_scatter_max():
    """One add-compare-select step of both recursions equals JAX's: the
    forward step's scatter-max new.at[:, nxt].max(alpha + g) and the backward
    step's max_x g + beta[nxt], each normalized, on metrics with unreachable
    (-1e30) states."""
    nxt, _, _ = jturbo._tables()
    rng = np.random.default_rng(0)
    N = 64
    alpha = rng.standard_normal((N, 8)).astype(np.float32) * 5
    beta = rng.standard_normal((N, 8)).astype(np.float32) * 5
    alpha[::3, 1:] = np.float32(-1e30)
    beta[1::4, 2:6] = np.float32(-1e30)
    ga = rng.standard_normal((N, 8, 2)).astype(np.float32) * 3
    gb = rng.standard_normal((N, 8, 2)).astype(np.float32) * 3
    # JAX, as _siso's a_body and b_body compute them
    cand = jnp.asarray(alpha)[:, :, None] + jnp.asarray(ga)
    new_a = jnp.full((N, 8), np.float32(-1e30)).at[:, jnp.asarray(nxt).reshape(-1)].max(
        cand.reshape(N, 16))
    new_a = new_a - jnp.max(new_a, axis=-1, keepdims=True)
    new_b = jnp.max(jnp.asarray(gb) + jnp.asarray(beta)[:, jnp.asarray(nxt)], axis=-1)
    new_b = new_b - jnp.max(new_b, axis=-1, keepdims=True)
    # the port: the branch metrics in the step's pair order
    idx, pred_s, pred_x, _, _, _ = tturbo._trellis(torch.device("cpu"))
    w = torch.cat([torch.as_tensor(ga)[:, pred_s, pred_x], torch.as_tensor(gb)], dim=1)
    out = torch.empty((N, 16))
    tturbo._acs(torch.as_tensor(np.concatenate([alpha, beta], 1)), idx, w, out)
    np.testing.assert_array_equal(out[:, :8].numpy(), np.asarray(new_a))
    np.testing.assert_array_equal(out[:, 8:].numpy(), np.asarray(new_b))


@pytest.mark.parametrize("K", [40, 512])
def test_siso_matches_jax(K):
    rng = np.random.default_rng(K + 1)
    ls, lp, la = (rng.standard_normal((4, K)).astype(np.float32) * 4 for _ in range(3))
    st, pt = (rng.standard_normal((4, 3)).astype(np.float32) * 4 for _ in range(2))
    got = tturbo._siso(*(torch.as_tensor(a) for a in (ls, lp, la, st, pt)))
    want = jturbo._siso(*(jnp.asarray(a) for a in (ls, lp, la, st, pt)))
    assert _rel(got.numpy(), want) <= LLR_TOL


@pytest.mark.parametrize("K,snr_db,n_iters,ext_scale", [
    (40, 2.0, 6, 0.75), (512, -1.0, 6, 0.75), (512, 2.0, 2, 1.0), (3200, -1.0, 4, 0.75),
])
def test_decode_matches_jax(K, snr_db, n_iters, ext_scale):
    """Decoded bits equal JAX's, LLRs within 1e-3; at 2 dB every
    block decodes to the sent bits."""
    bits, llrs = _stream_llrs(K, 4, snr_db, seed=K)
    got_b, got_l = tturbo.decode(*(torch.as_tensor(x) for x in llrs), n_iters=n_iters,
                                 ext_scale=ext_scale)
    want_b, want_l = _compiled(lambda a, b, c: jturbo.decode(a, b, c, n_iters=n_iters,
                                                             ext_scale=ext_scale),
                               *(jnp.asarray(x) for x in llrs))
    assert got_b.dtype == torch.int8
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert _rel(got_l.numpy(), want_l) <= LLR_TOL
    if snr_db >= 2.0:
        np.testing.assert_array_equal(got_b.numpy(), bits)
