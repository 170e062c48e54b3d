"""The port's PUCCH formats 0-4, UCI coding and PRACH against the JAX
package's, on the CPU.

Tolerances:
* host tables (sequence groups, cyclic shifts, OCC, N_CS, root maps, the
  restricted sets, the preamble map): equal;
* TX grids and preambles within 1e-6 (absolute; the PRACH preambles of
  magnitude up to sqrt(L_RA) within 1e-6 of their largest magnitude);
* UCI coded bits equal; decoded UCI and its ok flags equal, on batches that
  hold a pure-noise row; F0 energies and F1 correlations within 1e-4
  relative; the small-block confidence within 1e-5 (the port folds the
  repetitions by a reshape and sum, the JAX package by a scatter-add);
* PRACH detected, preamble and delay equal, the metric within 1e-4 relative.
Each JAX function is compiled as one program by XLA at its CPU optimization
level 0 (eagerly it compiles op by op, several times as long).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.models import prach as jprach
from openairinterface5g_tpu.models import pucch as jpucch
from openairinterface5g_tpu_torch.models import prach as tprach
from openairinterface5g_tpu_torch.models import pucch as tpucch

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

B = 4


def _jx(fn, *arrays):
    """fn on the numpy arrays as JAX arrays, compiled by XLA at its CPU
    backend's optimization level 0."""
    args = [jnp.asarray(a) for a in arrays]
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _rx(rng, tx, n_rx=2, sigma=0.5, fading=True):
    """(B, ...) TX -> (B, n_rx, ...) through a flat channel (Rayleigh, or a
    random phase without `fading`) and complex noise of std sigma; the last
    row is noise only."""
    shape = (tx.shape[0], n_rx) + tx.shape[1:]
    h = (rng.standard_normal(shape[:2]) + 1j * rng.standard_normal(shape[:2])) / np.sqrt(2)
    if not fading:
        h = h / np.abs(h)
    h = h.reshape(shape[:2] + (1,) * (tx.ndim - 1))
    noise = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    rx = h * tx[:, None] + sigma * noise
    rx[-1] = noise[-1]
    return rx.astype(np.complex64)


def _same(got, want, atol=0.0):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=0, atol=atol)


# --------------------------------------------------------------------------
# PUCCH
# --------------------------------------------------------------------------

F01 = [dict(), dict(n_symbols=2, start_symbol=12, slot=3, hopping_id=41, group_hopping="enable",
                    intra_slot_hopping=True, initial_cs=3),
       dict(n_symbols=2, start_symbol=12, slot=5, hopping_id=1001, group_hopping="disable")]


@pytest.mark.parametrize("n_bits", [1, 2])
@pytest.mark.parametrize("kw", F01)
def test_pucch0_matches_jax(kw, n_bits):
    jc, tc = jpucch.Pucch0Config(n_bits=n_bits, **kw), tpucch.Pucch0Config(n_bits=n_bits, **kw)
    assert tpucch._symbol_states(tc) == jpucch._symbol_states(jc)
    rng = np.random.default_rng(n_bits)
    uci = rng.integers(0, 1 << n_bits, B)
    tx = tpucch.pucch0_tx(tc, torch.as_tensor(uci))
    _same(tx, _jx(lambda u: jpucch.pucch0_tx(jc, u), uci), 1e-6)
    rx = _rx(rng, tx.numpy(), sigma=0.7)
    got, energy = tpucch.pucch0_rx(tc, torch.as_tensor(rx))
    want, wenergy = _jx(lambda r: jpucch.pucch0_rx(jc, r), rx)
    _same(got, want)
    np.testing.assert_allclose(energy.numpy(), np.asarray(wenergy), rtol=1e-4)


@pytest.mark.parametrize("n_bits", [1, 2])
@pytest.mark.parametrize("kw", [dict(), dict(n_symbols=10, start_symbol=2, occ_index=1,
                                              hopping_id=77, group_hopping="enable",
                                              intra_slot_hopping=True, slot=2)])
def test_pucch1_matches_jax(kw, n_bits):
    jc, tc = jpucch.Pucch1Config(n_bits=n_bits, **kw), tpucch.Pucch1Config(n_bits=n_bits, **kw)
    rng = np.random.default_rng(10 + n_bits)
    uci = rng.integers(0, 1 << n_bits, B)
    tx = tpucch.pucch1_tx(tc, torch.as_tensor(uci))
    _same(tx, _jx(lambda u: jpucch.pucch1_tx(jc, u), uci), 1e-6)
    rx = _rx(rng, tx.numpy(), sigma=1.0)
    got, corr = tpucch.pucch1_rx(tc, torch.as_tensor(rx))
    want, wcorr = _jx(lambda r: jpucch.pucch1_rx(jc, r), rx)
    _same(got, want)
    np.testing.assert_allclose(corr.numpy(), np.asarray(wcorr), rtol=1e-4)


@pytest.mark.parametrize("n_bits,n_prb", [(4, 4), (11, 1), (64, 16)])
def test_pucch2_matches_jax(n_bits, n_prb):
    """Small block at 4 and 11 bits; polar with CRC11 at 64 bits (16 PRB)."""
    kw = dict(n_bits=n_bits, n_prb=n_prb, rnti=0x4601, n_id=9, n_id0=3)
    jc, tc = jpucch.Pucch2Config(**kw), tpucch.Pucch2Config(**kw)
    rng = np.random.default_rng(n_bits)
    uci = rng.integers(0, 2, (B, n_bits)).astype(np.int8)
    np.testing.assert_array_equal(tpucch.pucch2_encode(tc, torch.as_tensor(uci)).numpy(),
                                  np.asarray(_jx(lambda u: jpucch.pucch2_encode(jc, u), uci)))
    tx = tpucch.pucch2_tx(tc, torch.as_tensor(uci))
    _same(tx, _jx(lambda u: jpucch.pucch2_tx(jc, u), uci), 1e-6)
    rx = _rx(rng, tx.numpy(), sigma=0.5, fading=False)
    got, ok = tpucch.pucch2_rx(tc, torch.as_tensor(rx))
    want, wok = _jx(lambda r: jpucch.pucch2_rx(jc, r), rx)
    _same(ok, wok)
    _same(got, want)
    assert bool(ok[:-1].all()) and torch.equal(got[:-1], torch.as_tensor(uci[:-1]))


@pytest.mark.parametrize("kw", [dict(fmt=3, n_bits=8, n_prb=1),
                                dict(fmt=3, n_bits=11, n_prb=2, pi2_bpsk=True),
                                dict(fmt=3, n_bits=6, n_prb=3, n_symbols=10, additional_dmrs=True,
                                     hopping_id=45),
                                dict(fmt=4, n_bits=10, occ_len=2, occ_index=1),
                                dict(fmt=4, n_bits=7, occ_len=4, occ_index=3)])
def test_pucch34_matches_jax(kw):
    jc, tc = jpucch.Pucch34Config(**kw), tpucch.Pucch34Config(**kw)
    assert (tc.E, tc.dmrs_symbols, tc.data_symbols) == (jc.E, jc.dmrs_symbols, jc.data_symbols)
    rng = np.random.default_rng(kw["n_bits"])
    uci = rng.integers(0, 2, (B, kw["n_bits"])).astype(np.int8)
    tx = tpucch.pucch34_tx(tc, torch.as_tensor(uci))
    _same(tx, _jx(lambda u: jpucch.pucch34_tx(jc, u), uci), 1e-6)
    rx = _rx(rng, tx.numpy(), sigma=0.5)
    got, ok = tpucch.pucch34_rx(tc, torch.as_tensor(rx))
    want, wok = _jx(lambda r: jpucch.pucch34_rx(jc, r), rx)
    _same(ok, wok)
    _same(got, want)


@pytest.mark.parametrize("n_bits,E", [(1, 20), (3, 32), (7, 100), (11, 257)])
def test_small_block_uci_matches_jax(n_bits, E):
    rng = np.random.default_rng(E)
    uci = rng.integers(0, 2, (B, n_bits)).astype(np.int8)
    cw = tpucch.uci_encode(n_bits, E, torch.as_tensor(uci))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(_jx(lambda u: jpucch.uci_encode(n_bits, E, u), uci)))
    llr = ((1 - 2.0 * cw.numpy()) + 1.2 * rng.standard_normal(cw.shape)).astype(np.float32)
    llr[-1] = rng.standard_normal(E)
    got, ok = tpucch.uci_decode(n_bits, E, torch.as_tensor(llr))
    want, wok = _jx(lambda x: jpucch.uci_decode(n_bits, E, x), llr)
    _same(got, want)
    _same(ok, wok)
    # the confidence behind ok, from the folded LLRs
    pad = (-E) % 32
    folded = np.concatenate([llr, np.zeros((B, pad), np.float32)], -1).reshape(B, -1, 32).sum(1)
    jfold = np.zeros((B, 32), np.float32)
    np.add.at(jfold, (slice(None), np.arange(E) % 32), llr)
    np.testing.assert_allclose(folded, jfold, rtol=0, atol=1e-5 * np.abs(jfold).max())


def test_pucch_tables_match_jax():
    for u in (0, 7, 29):
        for m in (6, 12, 18, 24):
            np.testing.assert_array_equal(tpucch.low_papr_base(u, m), jpucch.low_papr_base(u, m))
        for a in range(12):
            np.testing.assert_array_equal(tpucch.cyclic_shifted(u, a), jpucch.cyclic_shifted(u, a))
    for hid in (0, 41, 1001):
        for slot in (0, 3, 19):
            assert tpucch.hopped_group(hid, slot) == jpucch.hopped_group(hid, slot)
            assert tpucch.hopped_group(hid, slot, enabled=False) == \
                jpucch.hopped_group(hid, slot, enabled=False)
            for sym in (0, 13):
                assert tpucch._ncs_symbol(hid, slot, sym) == jpucch._ncs_symbol(hid, slot, sym)
    for n in (1, 2, 3, 4, 7):
        np.testing.assert_array_equal(tpucch._occ_matrix(n), jpucch._occ_matrix(n))
    for sf in (2, 4):
        for i in range(sf):
            np.testing.assert_array_equal(tpucch._f4_occ(sf, i), jpucch._f4_occ(sf, i))
    for kw in (dict(), dict(fmt=4, occ_len=4, occ_index=2), dict(n_prb=3, hopping_id=33)):
        np.testing.assert_array_equal(tpucch._f34_dmrs_seq(tpucch.Pucch34Config(**kw)),
                                      jpucch._f34_dmrs_seq(jpucch.Pucch34Config(**kw)))


# --------------------------------------------------------------------------
# PRACH
# --------------------------------------------------------------------------

def test_prach_tables_match_jax():
    for name in ("NCS_125_UNRESTRICTED", "NCS_125_RESTRICTED_A", "NCS_125_RESTRICTED_B",
                 "NCS_5_UNRESTRICTED", "NCS_5_RESTRICTED_A", "NCS_5_RESTRICTED_B", "NCS_SHORT"):
        assert getattr(tprach, name) == getattr(jprach, name), name
    for fmt, restricted, n in (("0", 0, 16), ("0", 1, 15), ("2", 2, 13), ("3", 0, 16),
                               ("3", 1, 16), ("3", 2, 14), ("A2", 0, 16)):
        for i in range(n):
            assert tprach.get_ncs(i, fmt, restricted) == jprach.get_ncs(i, fmt, restricted)
    for start in (0, 1, 137, 837):
        for l_ra in (839, 139):
            assert tprach.nr_roots(start, 5, l_ra) == jprach.nr_roots(start, 5, l_ra)
    for u in (1, 2, 25, 129, 140, 300, 419, 710, 838):
        for n_cs in (13, 15, 46, 59, 119, 237):
            for restricted in (0, 1, 2):
                assert tprach.cyclic_shifts(u, 839, n_cs, restricted) == \
                    jprach.cyclic_shifts(u, 839, n_cs, restricted), (u, n_cs, restricted)
    for fmt in jprach.PRACH_FORMATS:
        assert tprach.PRACH_FORMATS[fmt] == jprach.PRACH_FORMATS[fmt]
        jc = jprach.PrachTdConfig(fmt=fmt, mu=1, sample_rate=122.88e6)
        tc = tprach.PrachTdConfig(fmt=fmt, mu=1, sample_rate=122.88e6)
        assert (tc.l_ra, tc.scs, tc.n_rep, tc.n_fft, tc.cp_samples, tc.n_samples) == \
            (jc.l_ra, jc.scs, jc.n_rep, jc.n_fft, jc.cp_samples, jc.n_samples)


def _check_detect(got, want):
    for k in ("detected", "preamble", "delay"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["metric"].numpy(), np.asarray(want["metric"]), rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(roots=(129, 140), n_cs=13),
                                dict(roots=tprach.nr_roots(116, 4), n_cs=68, restricted=1),
                                dict(l_ra=139, roots=(1, 138), n_cs=11, n_ifft=256)])
def test_prach_freq_matches_jax(kw):
    jc, tc = jprach.PrachConfig(**kw), tprach.PrachConfig(**kw)
    assert tc.preamble_map == jc.preamble_map
    assert tc.n_preambles > 0
    rng = np.random.default_rng(tc.n_preambles)
    pre = rng.integers(0, min(64, tc.n_preambles), B)
    tx = tprach.prach_tx(tc, torch.as_tensor(pre))
    want_tx = np.asarray(_jx(lambda x: jprach.prach_tx(jc, x), pre))
    _same(tx, want_tx, 1e-6 * np.abs(want_tx).max())
    d = 3                                  # an integer delay in the L_RA domain
    ramp = np.exp(-2j * np.pi * d * np.arange(tc.l_ra) / tc.l_ra).astype(np.complex64)
    rx = _rx(rng, tx.numpy() * ramp, sigma=4.0)
    got = tprach.prach_rx(tc, torch.as_tensor(rx))
    _check_detect(got, _jx(lambda x: jprach.prach_rx(jc, x), rx))
    assert got["detected"].numpy().tolist() == [True] * (B - 1) + [False]


@pytest.mark.parametrize("kw", [dict(fmt="0", roots=(129, 710), n_cs=13),
                                dict(fmt="0", roots=tprach.nr_roots(116, 3), n_cs=68, restricted=1),
                                dict(fmt="A2", mu=1, sample_rate=122.88e6, roots=(1, 138),
                                     n_cs=11),
                                dict(fmt="B4", roots=(1,), n_cs=6)])
def test_prach_td_matches_jax(kw):
    jc, tc = jprach.PrachTdConfig(**kw), tprach.PrachTdConfig(**kw)
    rng = np.random.default_rng(len(kw["roots"]))
    assert tc.freq_cfg().n_preambles > 0
    pre = rng.integers(0, min(64, tc.freq_cfg().n_preambles), B)
    tx = tprach.prach_td_tx(tc, torch.as_tensor(pre))
    want_tx = np.asarray(_jx(lambda x: jprach.prach_td_tx(jc, x), pre))
    _same(tx, want_tx, 1e-5 * np.abs(want_tx).max())
    rx = _rx(rng, np.roll(tx.numpy(), 5, axis=-1), sigma=3.0)
    got = tprach.prach_td_rx(tc, torch.as_tensor(rx))
    _check_detect(got, _jx(lambda x: jprach.prach_td_rx(jc, x), rx))
