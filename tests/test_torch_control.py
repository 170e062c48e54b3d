"""The port's PDCCH, PBCH/SSB and initial sync against the JAX package's, on
the CPU.

Tolerances:
* coded bits, CRCs, host patterns (CORESET maps, search spaces, the PBCH
  interleaver, MIB pack/unpack, burst patterns): equal;
* TX grids (pdcch_tx_grid, ssb_generate) within 1e-6, ssb_time_signal
  within 1e-6 of its largest magnitude;
* decoded payloads and CRC flags (pdcch_rx, blind_search, ssb_receive):
  equal, on batches that hold a pure-noise row;
* sync: t0 and n_id equal, cfo_hz within 1e-3 of the SCS, the PSS and SSS
  metrics within 1e-4 relative.
The JAX receivers with an SCL decode run eagerly, as the JAX package's own
tests run them: the PDCCH and PBCH codes share N = 512 and the batch size,
so their SCL operations compile once for pdcch_rx, blind_search and
ssb_receive.  The other JAX functions (the encoders, TX grids and
initial_sync) are each compiled as one program by XLA at its CPU
optimization level 0, which takes a fraction of their op-by-op compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.config import make_frame_params as jframe
from openairinterface5g_tpu.models import pbch as jpbch
from openairinterface5g_tpu.models import pdcch as jpdcch
from openairinterface5g_tpu.models import sync as jsync
from openairinterface5g_tpu_torch.config import make_frame_params as tframe
from openairinterface5g_tpu_torch.models import pbch as tpbch
from openairinterface5g_tpu_torch.models import pdcch as tpdcch
from openairinterface5g_tpu_torch.models import sync as tsync

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

B = 4


def _jx(fn, *arrays):
    """fn on the numpy arrays as JAX arrays, compiled by XLA at its CPU
    backend's optimization level 0."""
    args = [jnp.asarray(a) for a in arrays]
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)
CORESET = dict(n_prb=48, interleaved=True, reg_bundle_size=6, interleaver_rows=2, shift=5)


def _noisy(rng, tx, n_rx, sigma, phase=0.3):
    """tx (B, ...) -> (B, n_rx, ...) complex64: a phase per antenna, complex
    noise of std sigma; the last row is noise only."""
    shape = (tx.shape[0], n_rx) + tx.shape[1:]
    h = np.exp(1j * phase * (1 + np.arange(n_rx))).reshape((1, n_rx) + (1,) * (tx.ndim - 1))
    noise = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    rx = tx[:, None] * h + sigma * noise
    rx[-1] = noise[-1]
    return rx.astype(np.complex64)


# --------------------------------------------------------------------------
# PDCCH
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_prb=48), CORESET,
                                dict(n_prb=270, interleaved=True, reg_bundle_size=6,
                                     interleaver_rows=3, shift=7),
                                dict(n_prb=24, interleaved=True, reg_bundle_size=2,
                                     interleaver_rows=6)])
def test_coreset_and_search_space_match_jax(kw):
    jcs, tcs = jpdcch.CoresetConfig(**kw), tpdcch.CoresetConfig(**kw)
    np.testing.assert_array_equal(tcs.bundle_perm(), jcs.bundle_perm())
    for al in (1, 2, 4, 8, 16):
        if 6 * al > tcs.n_reg:
            continue
        for cce0 in range(0, tcs.n_cce - al + 1, al):
            np.testing.assert_array_equal(tcs.cce_prbs(range(cce0, cce0 + al)),
                                          jcs.cce_prbs(range(cce0, cce0 + al)))
        for css, slot in ((True, 0), (False, 0), (False, 7)):
            args = (al, 4, 0x4601, slot, css)
            assert (tpdcch.search_space_candidates(tcs, *args)
                    == jpdcch.search_space_candidates(jcs, *args))


def _dci(module, al=4, cce=4):
    return module.DciConfig(A=39, aggregation_level=al, rnti=0x4601, n_id=17,
                            coreset=module.CoresetConfig(**CORESET), cce_index=cce)


def test_dci_encode_and_grid_match_jax():
    rng = np.random.default_rng(1)
    pay = rng.integers(0, 2, (B, 39)).astype(np.int8)
    for al, cce in ((4, 4), (8, 0)):
        jc, tc = _dci(jpdcch, al, cce), _dci(tpdcch, al, cce)
        np.testing.assert_array_equal(tpdcch.dci_encode(tc, torch.as_tensor(pay)).numpy(),
                                      np.asarray(_jx(lambda x: jpdcch.dci_encode(jc, x), pay)))
        np.testing.assert_allclose(tpdcch.pdcch_tx_grid(tc, torch.as_tensor(pay), slot=3).numpy(),
                                   np.asarray(_jx(lambda x: jpdcch.pdcch_tx_grid(jc, x, slot=3), pay)),
                                   rtol=0, atol=1e-6)


def test_pdcch_rx_matches_jax():
    rng = np.random.default_rng(2)
    pay = rng.integers(0, 2, (B, 39)).astype(np.int8)
    jc, tc = _dci(jpdcch), _dci(tpdcch)
    tx = tpdcch.pdcch_tx_grid(tc, torch.as_tensor(pay), slot=3).numpy()
    rx = _noisy(rng, tx, 2, 0.7)
    got, ok = tpdcch.pdcch_rx(tc, torch.as_tensor(rx), slot=3)
    want, wok = jpdcch.pdcch_rx(jc, jnp.asarray(rx), slot=3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ok.numpy().tolist() == [True] * (B - 1) + [False]


def test_blind_search_matches_jax():
    """The DCI at AL 8 (the second level searched) on the interleaved
    CORESET, found by both at the same level."""
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 2, (B, 39)).astype(np.int8)
    cs_args = dict(aggregation_levels=(4, 8), candidates_per_al=(2, 1), n_id=17, slot=3)
    tx = tpdcch.pdcch_tx_grid(_dci(tpdcch, 8, 0), torch.as_tensor(pay), slot=3).numpy()
    rx = _noisy(rng, tx, 1, 0.3)
    got = tpdcch.blind_search(torch.as_tensor(rx), 39, 0x4601,
                              coreset=tpdcch.CoresetConfig(**CORESET), **cs_args)
    want = jpdcch.blind_search(jnp.asarray(rx), 39, 0x4601,
                               coreset=jpdcch.CoresetConfig(**CORESET), **cs_args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].numpy().tolist() == [True] * (B - 1) + [False]
    assert got[2].numpy().tolist() == [8] * (B - 1) + [0]


# --------------------------------------------------------------------------
# PBCH / SSB
# --------------------------------------------------------------------------

def test_pbch_patterns_match_jax():
    np.testing.assert_array_equal(tpbch._ILV, jpbch._ILV)
    np.testing.assert_array_equal(tpbch._ILV_INV, jpbch._ILV_INV)
    assert tpbch._EXEMPT == jpbch._EXEMPT
    for n_id in (0, 1, 2, 3, 1007):
        for cls in (dict(), dict(i_ssb=5), dict(i_ssb=3, n_hf=1, lmax=4), dict(i_ssb=45, lmax=64)):
            jc, tc = jpbch.PbchConfig(n_id=n_id, **cls), tpbch.PbchConfig(n_id=n_id, **cls)
            np.testing.assert_array_equal(tpbch._dmrs_positions(tc), jpbch._dmrs_positions(jc))
            np.testing.assert_array_equal(tpbch._data_positions(tc), jpbch._data_positions(jc))
            np.testing.assert_array_equal(tpbch.pbch_dmrs(tc).numpy(), np.asarray(jpbch.pbch_dmrs(jc)))
            assert (tc.v, tc.v2, tc.i_ssb_eff) == (jc.v, jc.v2, jc.i_ssb_eff)


def test_mib_and_burst_patterns_match_jax():
    for mib_kw, sfn, hrf, idx, lmax in ((dict(k_ssb=22, pdcch_config_sib1=0xA5), 517, 1, 3, 8),
                                        (dict(k_ssb=9, cell_barred=1), 900, 0, 45, 64),
                                        (dict(), 0, 0, 0, 4)):
        a = tpbch.mib_payload(tpbch.Mib(**mib_kw), sfn, hrf, idx, lmax)
        np.testing.assert_array_equal(a, jpbch.mib_payload(jpbch.Mib(**mib_kw), sfn, hrf, idx, lmax))
        got, want = tpbch.mib_unpack(a[None], lmax), jpbch.mib_unpack(a[None], lmax)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for case, lmax in (("A", 4), ("A", 8), ("B", 4), ("B", 8), ("C", 8), ("D", 64), ("E", 64)):
        np.testing.assert_array_equal(tpbch.ssb_first_symbols(case, lmax),
                                      jpbch.ssb_first_symbols(case, lmax))
        for slot in range(6):
            assert tpbch.ssb_in_slot(case, lmax, slot) == jpbch.ssb_in_slot(case, lmax, slot)


@pytest.mark.parametrize("cls", [dict(n_id=77, i_ssb=1), dict(n_id=200, i_ssb=13, lmax=64),
                                 dict(n_id=5, i_ssb=2, n_hf=1, lmax=4)])
def test_pbch_encode_and_ssb_match_jax(cls):
    rng = np.random.default_rng(cls["n_id"])
    pay = rng.integers(0, 2, (B, 32)).astype(np.int8)
    jc, tc = jpbch.PbchConfig(**cls), tpbch.PbchConfig(**cls)
    np.testing.assert_array_equal(tpbch.pbch_encode(tc, torch.as_tensor(pay)).numpy(),
                                  np.asarray(_jx(lambda x: jpbch.pbch_encode(jc, x), pay)))
    np.testing.assert_allclose(tpbch.ssb_generate(tc, torch.as_tensor(pay)).numpy(),
                               np.asarray(_jx(lambda x: jpbch.ssb_generate(jc, x), pay)),
                               rtol=0, atol=1e-6)


def test_ssb_receive_matches_jax():
    rng = np.random.default_rng(4)
    pay = rng.integers(0, 2, (B, 32)).astype(np.int8)
    jc, tc = jpbch.PbchConfig(n_id=77, i_ssb=1), tpbch.PbchConfig(n_id=77, i_ssb=1)
    rx = _noisy(rng, tpbch.ssb_generate(tc, torch.as_tensor(pay)).numpy(), 2, 1.2)
    got, ok = tpbch.ssb_receive(tc, torch.as_tensor(rx))
    want, wok = jpbch.ssb_receive(jc, jnp.asarray(rx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ok.numpy().tolist() == [True] * (B - 1) + [False]


# --------------------------------------------------------------------------
# initial sync
# --------------------------------------------------------------------------

def _stream(seed, n_id, off, snr_db, cfo_hz, fp):
    """SSB of cell n_id at sample `off` of a noisy stream, rotated by cfo_hz
    (numpy, float64 phase)."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 2, (B, 32)).astype(np.int8)
    tile = tpbch.ssb_generate(tpbch.PbchConfig(n_id=n_id), torch.as_tensor(pay))
    ssb = tsync.ssb_time_signal(fp, tile).numpy()
    n = ssb.shape[-1] + 1500
    sigma = float(np.sqrt(np.mean(np.abs(ssb) ** 2))) * 10 ** (-snr_db / 20)
    s = sigma * (rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))) / np.sqrt(2)
    s[:, off: off + ssb.shape[-1]] += ssb
    return (s * np.exp(2j * np.pi * cfo_hz * np.arange(n) / fp.sample_rate)).astype(np.complex64)


def test_ssb_time_signal_matches_jax():
    fp = tframe(1, 24)
    pay = np.random.default_rng(5).integers(0, 2, (B, 32)).astype(np.int8)
    tile = tpbch.ssb_generate(tpbch.PbchConfig(n_id=321), torch.as_tensor(pay))
    for k in (0, 12):
        got = tsync.ssb_time_signal(fp, tile, k_offset=k).numpy()
        want = np.asarray(_jx(lambda x: jsync.ssb_time_signal(jframe(1, 24), x, k), tile.numpy()))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("cfo_scan,cfo_hz", [(0, 0.0), (1, 17500.0), (1, -9000.0)])
def test_initial_sync_matches_jax(cfo_scan, cfo_hz):
    tfp, jfp = tframe(1, 24), jframe(1, 24)
    s = _stream(6, 321, 400, 10.0, cfo_hz, tfp)
    got = tsync.initial_sync(tfp, torch.as_tensor(s), cfo_scan=cfo_scan)
    want = _jx(lambda x: jsync.initial_sync(jfp, x, cfo_scan=cfo_scan), s)
    for k in ("t0", "n_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["n_id"].numpy(), 321)
    np.testing.assert_array_equal(got["t0"].numpy(), 400)
    np.testing.assert_allclose(got["cfo_hz"].numpy(), np.asarray(want["cfo_hz"]), rtol=0,
                               atol=1e-3 * tfp.scs)
    for k in ("pss_metric", "sss_metric"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4)
    if cfo_scan:
        assert np.all(np.abs(got["cfo_hz"].numpy() - cfo_hz) < 0.02 * tfp.scs)


def test_sync_pieces_match_jax():
    tfp, jfp = tframe(1, 24), jframe(1, 24)
    s = _stream(7, 100, 300, -3.0, 5000.0, tfp)
    x = torch.as_tensor(s)
    t0, n2, m = tsync.pss_search(tfp, x)
    jt0, jn2, jm = jsync.pss_search(jfp, jnp.asarray(s))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    np.testing.assert_array_equal(n2.numpy(), np.asarray(jn2))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4)
    comp = tsync.compensate_cfo(tfp, x, 5000.0).numpy()
    jcomp = np.asarray(jsync.compensate_cfo(jfp, jnp.asarray(s), 5000.0))
    assert np.abs(comp - jcomp).max() <= 1e-5 * np.abs(jcomp).max()
    f = tsync.estimate_cfo_pss(tfp, torch.as_tensor(comp), t0, n2).numpy()
    jf = np.asarray(jsync.estimate_cfo_pss(jfp, jnp.asarray(comp), jt0, jn2))
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-3 * tfp.scs)
    h = np.exp(-2j * np.pi * 3 * np.arange(64) / 64)[None].astype(np.complex64)
    assert tsync.timing_drift_estimate(torch.as_tensor(h)).numpy().tolist() == \
        np.asarray(jsync.timing_drift_estimate(jnp.asarray(h))).tolist()
