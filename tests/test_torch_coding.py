"""Coding chain of the PyTorch port against the JAX package, on the CPU.

Same numpy inputs (from a seed) into both; CRC, segmentation, graph
tables, encoding and rate matching must agree bit for bit, and the
flooding decoder's hard bits must equal ldpc.decode's at equal iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.coding import crc as jcrc
from openairinterface5g_tpu.coding import ldpc as jldpc
from openairinterface5g_tpu.coding import rate_matching as jrm
from openairinterface5g_tpu.coding import segmentation as jseg
from openairinterface5g_tpu_torch.coding import crc as tcrc
from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.coding import rate_matching as trm
from openairinterface5g_tpu_torch.coding import segmentation as tseg
from openairinterface5g_tpu_torch.coding.backend import decoder

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", sorted(jcrc.CRC_POLYS))
def test_crc_bit_exact(name):
    rng = np.random.default_rng(len(name))
    bits = rng.integers(0, 2, (3, 2, 517)).astype(np.int8)
    np.testing.assert_array_equal(tcrc.remainder_matrix(517, name),
                                  jcrc.remainder_matrix(517, name))
    want = np.asarray(jcrc.crc_attach(jnp.asarray(bits), name))
    got = tcrc.crc_attach(_t(bits), name)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(tcrc.crc_ok(got, name).all())
    bad = got.clone()
    bad[0, 1, 5] ^= 1
    np.testing.assert_array_equal(tcrc.crc_ok(bad, name).numpy(),
                                  np.asarray(jcrc.crc_ok(jnp.asarray(bad.numpy()), name)))


@pytest.mark.parametrize("B,bg", [(24, 2), (600, 2), (3000, 2), (8448, 1), (30000, 1),
                                  (217152, 1)])
def test_segmentation(B, bg):
    assert tseg.segment_params(B, bg).__dict__ == jseg.segment_params(B, bg).__dict__
    for rate in (0.2, 0.5, 0.9):
        assert tseg.base_graph_select(B, rate) == jseg.base_graph_select(B, rate)
    if B > 30000:
        return
    p = jseg.segment_params(B, bg)
    tb = np.random.default_rng(B).integers(0, 2, (2, B)).astype(np.int8)
    want = np.asarray(jseg.segment_tb(jnp.asarray(tb), p))
    got = tseg.segment_tb(_t(tb), tseg.segment_params(B, bg))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tseg.desegment_tb(got, p).numpy(),
                                  np.asarray(jseg.desegment_tb(jnp.asarray(want), p)))


@pytest.mark.parametrize("bg,Z", [(1, 2), (1, 13), (1, 384), (2, 64), (2, 104), (2, 384)])
def test_graph_tables(bg, Z):
    a, b = tldpc.build_graph(bg, Z), jldpc.build_graph(bg, Z)
    for f in ("bg", "Z", "kc", "rows", "cols", "max_deg", "p0_shift", "core_order",
              "K", "N", "N_full"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("tab", "ecol", "eshift", "evalid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("bg,Z,n_cols", [(1, 16, None), (1, 384, 27), (2, 64, None),
                                         (2, 104, 20)])
def test_encode_bit_exact(bg, Z, n_cols):
    g = jldpc.build_graph(bg, Z)
    info = np.random.default_rng(Z).integers(0, 2, (3, g.K)).astype(np.int8)
    want = np.asarray(jax.jit(lambda x: jldpc.encode(g, x, n_cols=n_cols))(jnp.asarray(info)))
    got = tldpc.encode(tldpc.build_graph(bg, Z), _t(info), n_cols=n_cols)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if n_cols is None:
        assert tldpc.check_parity_np(tldpc.build_graph(bg, Z), got[0].numpy())


RM_CASES = [  # bg, Z, rv, es, qm, F, ncb
    (1, 384, 0, (12480, 12480), 4, 344, None),
    (1, 384, 2, (9000, 9000, 9004), 2, 100, None),
    (2, 64, 3, (2400, 2406), 6, 40, None),
    (2, 64, 1, (4000,), 4, 0, 1920),          # repetition past a limited buffer
]


@pytest.mark.parametrize("bg,Z,rv,es,qm,F,ncb", RM_CASES)
def test_rate_matching_tables(bg, Z, rv, es, qm, F, ncb):
    kc = 22 if bg == 1 else 10
    for E in es:
        np.testing.assert_array_equal(trm.selection_indices(bg, Z, kc, rv, E, F, ncb),
                                      jrm.selection_indices(bg, Z, kc, rv, E, F, ncb))
        assert trm._rx_runs(bg, Z, kc, rv, E, F, ncb) == jrm._rx_runs(bg, Z, kc, rv, E, F, ncb)
    assert trm._cb_groups(es) == jrm._cb_groups(es)
    g = jldpc.build_graph(bg, Z)
    assert trm.tx_cols_needed(g, rv, es, F, ncb) == jrm.tx_cols_needed(g, rv, es, F, ncb)


@pytest.mark.parametrize("bg,Z,rv,es,qm,F,ncb", RM_CASES)
def test_rate_matching_tx_rx(bg, Z, rv, es, qm, F, ncb):
    g = jldpc.build_graph(bg, Z)
    rng = np.random.default_rng(rv + Z)
    C = len(es)
    cw = rng.integers(0, 2, (2, C, g.cols * Z)).astype(np.int8)
    want = np.asarray(jrm.fused_rate_match_tx(g, jnp.asarray(cw), rv, es, qm, F, ncb=ncb))
    got = trm.fused_rate_match_tx(g, _t(cw), rv, es, qm, F, ncb=ncb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        trm.interleave_tx(_t(cw[..., :96]), qm).numpy(),
        np.asarray(jrm.interleave_tx(jnp.asarray(cw[..., :96]), qm)))

    llr = rng.standard_normal((2, sum(es))).astype(np.float32)
    harq = rng.standard_normal((2, C, g.cols * Z)).astype(np.float32)
    want = np.asarray(jrm.fused_rate_match_rx(g, jnp.asarray(llr), rv, es, qm, F,
                                              harq_buffer=jnp.asarray(harq), ncb=ncb))
    got = trm.fused_rate_match_rx(g, _t(llr), rv, es, qm, F, harq_buffer=_t(harq), ncb=ncb)
    np.testing.assert_array_equal(got.numpy(), want)
    planes = llr.reshape(2, -1, qm).transpose(0, 2, 1).copy()   # any (B, qm, G/qm)
    want = np.asarray(jrm.fused_rate_match_rx_planes(g, jnp.asarray(planes), rv, es, qm, F,
                                                     ncb=ncb))
    got = trm.fused_rate_match_rx_planes(g, _t(planes), rv, es, qm, F, ncb=ncb)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rate_matching_rx_planes_bf16():
    """The bf16-staged buffer of the kernel decode path, fillers included."""
    bg, Z, rv, es, qm, F, ncb = RM_CASES[0]
    g = jldpc.build_graph(bg, Z)
    planes = np.random.default_rng(7).standard_normal((2, qm, sum(es) // qm)).astype(np.float32)
    want = np.asarray(jrm.fused_rate_match_rx_planes(
        g, jnp.asarray(planes).astype(jnp.bfloat16), rv, es, qm, F).astype(jnp.float32))
    got = trm.fused_rate_match_rx_planes(g, _t(planes).to(torch.bfloat16), rv, es, qm, F)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("bg,Z,snr_db", [(2, 64, 1.0), (1, 24, 0.5), (2, 32, 20.0)])
def test_flooding_decode_matches_jax(bg, Z, snr_db):
    g = jldpc.build_graph(bg, Z)
    rng = np.random.default_rng(Z)
    info = rng.integers(0, 2, (4, g.K)).astype(np.int8)
    cw = tldpc.encode(tldpc.build_graph(bg, Z), _t(info)).numpy().astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    llr = 2 * ((1 - 2 * cw) + sigma * rng.standard_normal(cw.shape).astype(np.float32)) / sigma ** 2
    llr[:, : 2 * Z] = 0
    wb, wok, _ = jax.jit(lambda x: jldpc.decode(g, x, n_iters=5, early_stop=False))(jnp.asarray(llr))
    gb, gok, iters = tldpc.decode(tldpc.build_graph(bg, Z), _t(llr), n_iters=5, early_stop=False)
    assert iters == 5
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    # the registry's reference entry stops early and still decodes
    bits, ok = decoder("reference")(tldpc.build_graph(bg, Z), _t(llr), n_iters=20)
    if bool(ok.all()):
        np.testing.assert_array_equal(bits.numpy(), info)


# ---- leftover functions of the ported modules (ROADMAP Queue 1 item 11) ----

@pytest.mark.parametrize("bg,Z,rv,es,qm,F,ncb", RM_CASES + [
    (1, 64, 0, (6000, 3000), 2, 0, None),    # E > Ncb = 4224: repetition, two layers
    (2, 16, 2, (2500,), 6, 8, 600),          # E > 4 x the limited buffer
])
def test_fused_rx_tables(bg, Z, rv, es, qm, F, ncb):
    """fused_rx_indices and its inverse gather layers, integer-equal to JAX's
    over BG1 and BG2, repetition included."""
    kc = 22 if bg == 1 else 10
    want = jrm.fused_rx_indices(bg, Z, kc, rv, es, qm, F, ncb)
    got = trm.fused_rx_indices(bg, Z, kc, rv, es, qm, F, ncb)
    assert got.dtype == want.dtype and got.shape == (sum(es),)
    np.testing.assert_array_equal(got, want)
    want = jrm.fused_rx_gather_layers(bg, Z, kc, rv, es, qm, F, ncb)
    got = trm.fused_rx_gather_layers(bg, Z, kc, rv, es, qm, F, ncb)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if max(es) > (ncb or (50 if bg == 2 else 66) * Z) - F:
        assert got.shape[0] > 1


def test_lbrm_helpers():
    """nprb_lbrm, compute_tbs_lbrm and ncb_lbrm equal JAX's
    (tests/test_ldpc.py:107), and the limited buffer rate-matches equal."""
    from openairinterface5g_tpu import transport as jtr
    from openairinterface5g_tpu_torch import transport as ttr
    for n_prb in (1, 24, 32, 33, 66, 106, 107, 162, 217, 273, 300):
        assert ttr.nprb_lbrm(n_prb) == jtr.nprb_lbrm(n_prb)
        for layers in (1, 2, 4, 8):
            for table in (1, 2):
                assert ttr.compute_tbs_lbrm(n_prb, layers, table) == \
                    jtr.compute_tbs_lbrm(n_prb, layers, table)
                for N, C in ((25344, 1), (25344, 10), (10400, 3), (3328, 26)):
                    assert ttr.ncb_lbrm(N, C, n_prb, layers, table) == \
                        jtr.ncb_lbrm(N, C, n_prb, layers, table)
    g = jldpc.build_graph(1, 384)
    ncb = ttr.ncb_lbrm(g.N, 10, 106)
    assert ncb < g.N
    for rv in (0, 2, 3):
        np.testing.assert_array_equal(trm.selection_indices(1, 384, 22, rv, ncb, 0, ncb),
                                      jrm.selection_indices(1, 384, 22, rv, ncb, 0, ncb))
