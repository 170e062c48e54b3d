"""PHY blocks of the PyTorch port against the JAX package, on the CPU.

Scrambling sequences, constellations and DMRS tables must be equal; float
outputs (modulation, OFDM, channel estimation, equalization, LLRs) within
1e-5 of the largest magnitude, float32 rounding in either framework.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.config import make_frame_params
from openairinterface5g_tpu.phy import channel_estimation as jce
from openairinterface5g_tpu.phy import equalization as jeq
from openairinterface5g_tpu.phy import llr as jllr
from openairinterface5g_tpu.phy import modulation as jmod
from openairinterface5g_tpu.phy import ofdm as jofdm
from openairinterface5g_tpu.phy import refsig as jref
from openairinterface5g_tpu.phy import scrambling as jscr
from openairinterface5g_tpu_torch.phy import channel_estimation as tce
from openairinterface5g_tpu_torch.phy import equalization as teq
from openairinterface5g_tpu_torch.phy import llr as tllr
from openairinterface5g_tpu_torch.phy import modulation as tmod
from openairinterface5g_tpu_torch.phy import ofdm as tofdm
from openairinterface5g_tpu_torch.phy import refsig as tref
from openairinterface5g_tpu_torch.phy import scrambling as tscr

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

RTOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    scale = float(np.max(np.abs(want))) + 1e-30
    err = float(np.max(np.abs(got - want))) / scale
    assert err < rtol, err


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("cinit,length", [(0, 31), (0x1234 << 15, 1000), (2**31 - 1, 4097),
                                          (5_000_001, 340704)])
def test_gold_sequence(cinit, length):
    want = jscr.gold_sequence_np(cinit, length)
    got = tscr.gold_sequence_np(cinit, length)
    np.testing.assert_array_equal(got, want)
    bits = np.random.default_rng(1).integers(0, 2, (2, length)).astype(np.int8)
    np.testing.assert_array_equal(tscr.scramble(_t(bits), cinit).numpy(),
                                  np.asarray(jscr.scramble(jnp.asarray(bits), cinit)))
    llr = np.random.default_rng(2).standard_normal((2, length)).astype(np.float32)
    _close(tscr.scramble_llrs(_t(llr), cinit), jscr.scramble_llrs(jnp.asarray(llr), cinit))


def test_pusch_cinit():
    for rnti, q, n_id in [(0x1234, 0, 0), (0xFFFF, 1, 1007), (1, 0, 5)]:
        assert tscr.pusch_cinit(rnti, q, n_id) == int(jscr.pusch_cinit(rnti, q, n_id))


@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_modulation(qm):
    np.testing.assert_array_equal(tmod.constellation(qm), jmod.constellation(qm))
    bits = np.random.default_rng(qm).integers(0, 2, (2, 24 * qm)).astype(np.int8)
    got = tmod.modulate(_t(bits), qm)
    _close(got, jmod.modulate(jnp.asarray(bits), qm))
    for L in (1, 2, 4):
        np.testing.assert_array_equal(tmod.layer_map(got, L).numpy(),
                                      np.asarray(jmod.layer_map(jnp.asarray(got.numpy()), L)))


def test_dmrs():
    for slot, sym, n_id in [(0, 2, 0), (7, 11, 1007), (19, 3, 12)]:
        c = tref.dmrs_cinit(slot, sym, n_id)
        assert c == jref.dmrs_cinit(slot, sym, n_id)
        np.testing.assert_array_equal(tref.dmrs_sequence_np(c, 1638),
                                      jref.dmrs_sequence_np(c, 1638))
    for n_prb, delta in [(1, 0), (273, 1)]:
        np.testing.assert_array_equal(tref.dmrs_type1_sc_indices(n_prb, delta),
                                      jref.dmrs_type1_sc_indices(n_prb, delta))
    for port in range(4):
        (wa, da), (wb, db) = tref.dmrs_type1_port_weights(port), jref.dmrs_type1_port_weights(port)
        np.testing.assert_array_equal(wa, wb)
        assert da == db


@pytest.mark.parametrize("mu,n_rb,slot", [(1, 20, 0), (1, 24, 3), (0, 52, 1), (1, 273, 0)])
def test_ofdm(mu, n_rb, slot):
    fp = make_frame_params(mu, n_rb)
    rng = np.random.default_rng(n_rb)
    re = _cplx(rng, (2, 14, fp.n_sc))
    grid_t = tofdm.map_to_grid(fp, _t(re))
    _close(grid_t, jofdm.map_to_grid(fp, jnp.asarray(re)))
    np.testing.assert_array_equal(tofdm.extract_from_grid(fp, grid_t).numpy(), re)
    tx_t = tofdm.ofdm_modulate(fp, grid_t, slot)
    _close(tx_t, jofdm.ofdm_modulate(fp, jnp.asarray(grid_t.numpy()), slot))
    rx = _cplx(rng, tuple(tx_t.shape))
    _close(tofdm.ofdm_demodulate(fp, _t(rx), slot),
           jofdm.ofdm_demodulate(fp, jnp.asarray(rx), slot))


def test_channel_estimation():
    rng = np.random.default_rng(3)
    y, p = _cplx(rng, (2, 2, 60)), _cplx(rng, (60,))
    _close(tce.ls_estimate(_t(y), _t(p)), jce.ls_estimate(jnp.asarray(y), jnp.asarray(p)))
    for delta in (0, 1):
        _close(tce.comb2_interpolate(_t(y), 120, delta),
               jce.comb2_interpolate(jnp.asarray(y), 120, delta))
    for w in (0, 1, 2, 5, 8):
        _close(tce.freq_average(_t(y), w), jce.freq_average(jnp.asarray(y), w))
    _close(tce.noise_variance(None, _t(y), None), jce.noise_variance(None, jnp.asarray(y), None))


def test_equalization():
    rng = np.random.default_rng(4)
    h1, y = _cplx(rng, (3, 2, 40)), _cplx(rng, (3, 2, 40))
    for a, b in zip(teq.mrc_compensate(_t(h1), _t(y)),
                    jeq.mrc_compensate(jnp.asarray(h1), jnp.asarray(y))):
        _close(a, b)
    h2 = _cplx(rng, (3, 2, 2, 40))
    nv = np.abs(rng.standard_normal((3, 1))).astype(np.float32)
    for a, b in zip(teq.mmse_equalize_2layer(_t(h2), _t(y), _t(nv)),
                    jeq.mmse_equalize_2layer(jnp.asarray(h2), jnp.asarray(y), jnp.asarray(nv))):
        _close(a, b)
    h4 = _cplx(rng, (3, 4, 3, 40))
    y4 = _cplx(rng, (3, 4, 40))
    for a, b in zip(teq.zf_equalize(_t(h4), _t(y4), 0.1),
                    jeq.zf_equalize(jnp.asarray(h4), jnp.asarray(y4), 0.1)):
        _close(a, b)


@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_llrs(qm):
    rng = np.random.default_rng(qm)
    x = _cplx(rng, (2, 2, 50))
    mag = np.abs(rng.standard_normal((2, 2, 50))).astype(np.float32)
    got = tllr.llrs(_t(x), _t(mag), qm)
    _close(got, jllr.llrs(jnp.asarray(x), jnp.asarray(mag), qm))
    _close(tllr.quantize(got * 3), jllr.quantize(jnp.asarray(got.numpy() * 3)))


# ---- leftover functions of the ported modules (ROADMAP Queue 1 item 11) ----

def test_pdsch_cinit_and_qam_orders():
    assert tmod.QAM_ORDERS == jmod.QAM_ORDERS
    for rnti, q, n_id in [(0x1234, 0, 0), (0xFFFF, 1, 1007), (1, 0, 5), (0x4601, 1, 1)]:
        assert tscr.pdsch_cinit(rnti, q, n_id) == int(jscr.pdsch_cinit(rnti, q, n_id))


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4])
def test_layer_demap(n_layers):
    """The inverse of layer_map (tests/test_phy.py:58) and equal to JAX's."""
    rng = np.random.default_rng(n_layers)
    sym = _cplx(rng, (2, 3, 12 * n_layers))
    layers = tmod.layer_map(_t(sym), n_layers)
    np.testing.assert_array_equal(tmod.layer_demap(layers).numpy(), sym)
    np.testing.assert_array_equal(tmod.layer_demap(layers).numpy(),
                                  np.asarray(jmod.layer_demap(jnp.asarray(layers.numpy()))))


@pytest.mark.parametrize("mu,n_rb,slot,f0", [(1, 24, 0, 3.5e9), (1, 273, 3, 3.6192e9),
                                              (0, 52, 1, 2.1e9), (1, 24, 0, 0.0)])
def test_symbol_rotation(mu, n_rb, slot, f0):
    """TS 38.211 §5.4 per-symbol rotation within 1e-6, TX then RX the identity."""
    fp = make_frame_params(mu, n_rb)
    rot = tofdm.symbol_rotation(fp, slot, f0)
    np.testing.assert_array_equal(rot, jofdm.symbol_rotation(fp, slot, f0))
    grid = _cplx(np.random.default_rng(9), (2, fp.symbols_per_slot, fp.fft_size))
    tx = tofdm.apply_rotation_tx(fp, _t(grid), slot, f0)
    _close(tx, jofdm.apply_rotation_tx(fp, jnp.asarray(grid), slot, f0), rtol=1e-6)
    rx = tofdm.apply_rotation_rx(fp, tx, slot, f0)
    _close(rx, jofdm.apply_rotation_rx(fp, jnp.asarray(tx.numpy()), slot, f0), rtol=1e-6)
    _close(rx, grid, rtol=1e-6)


def test_estimate_slot_and_common_phase():
    rng = np.random.default_rng(11)
    n_sc = 120
    for delta in (0, 1):
        y = _cplx(rng, (2, 2, n_sc))
        pilots = _cplx(rng, (n_sc // 2,))
        pilot_sc = np.arange(delta, n_sc, 2)
        h, nvar = tce.estimate_slot(_t(y), _t(pilots), pilot_sc, n_sc, delta)
        jh, jnvar = jce.estimate_slot(jnp.asarray(y), jnp.asarray(pilots), pilot_sc, n_sc, delta)
        _close(h, jh)
        _close(nvar, jnvar)
    y, h, pilots = _cplx(rng, (3, 14, 6)), _cplx(rng, (3, 14, 6)), _cplx(rng, (6,))
    y[0, 2] = 0                                       # a symbol with no energy: the 1e-12 floor
    got = tref.estimate_common_phase(_t(y), _t(h), _t(pilots))
    _close(got, jref.estimate_common_phase(jnp.asarray(y), jnp.asarray(h), jnp.asarray(pilots)))
    _close(tref.estimate_common_phase(_t(y), _t(h[:1]), _t(pilots)),
           jref.estimate_common_phase(jnp.asarray(y), jnp.asarray(h[:1]), jnp.asarray(pilots)))
