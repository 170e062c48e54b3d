"""The port's polar and small-block codes against the JAX package's, on the CPU.

Tolerances:
* polar_params, polar_transform, encode, the small-block encode and the
  rate-recovered LLRs: equal (the recovered LLRs bit for bit: the same
  additions in the same order).
* scl_decode: the L candidate payloads equal, path metrics within 1e-4
  relative to the largest finite metric (the check-node correction's
  log1p(exp(.)) rounds differently from XLA's); decode_with_crc: the chosen
  payload and the CRC flags equal.  Each batch holds noisy codewords at two
  SNRs, pure noise and all-zero LLRs: every branch an exact tie, so the
  surviving paths are decided by the prune's stable order alone.
* small_block.decode: bits equal, the confidence within 1e-5.

Four polar configurations, each one XLA program (at optimization level 0)
shared by its tests: PBCH (K 56, E 864, repetition), a DCI (K 64, E 216,
puncturing), a UCI with PC bits and CRC6 (K 22, E 240) and a UCI with
CRC11 (K 51, E 200).  The JAX encoders and rate recovery are compiled the
same way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.coding import polar as jpolar
from openairinterface5g_tpu.coding import small_block as jsb
from openairinterface5g_tpu_torch.coding import polar as tpolar
from openairinterface5g_tpu_torch.coding import small_block as tsb

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

# (id, polar_params kwargs, CRC)
CODES = {
    "pbch": (dict(K=56, E=864, n_max=9, i_il=True), "24C"),
    "dci": (dict(K=64, E=216, n_max=9, i_il=True), "24C"),
    "uci_pc": (dict(K=22, E=240, n_max=10, i_il=False, n_pc=3, i_bil=True), "6"),
    "uci_crc11": (dict(K=51, E=200, n_max=10, i_il=False, i_bil=True), "11"),
}
# more parameter sets for the host-side patterns: shortening, n_pc_wm,
# the largest UCI, a repetition DCI
MORE_PARAMS = [
    dict(K=22, E=30, n_max=10, i_il=False, n_pc=3, i_bil=True),
    dict(K=30, E=100, n_max=10, i_il=False, n_pc=3, n_pc_wm=1, i_bil=True),
    dict(K=1023 // 2, E=1500, n_max=10, i_il=False, i_bil=True),
    dict(K=36, E=1728, n_max=9, i_il=True),
]
B = 6          # rows: 2 at SNR 1 dB, 2 at -1 dB, pure noise, all-zero LLRs


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0 and called."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _inputs(p, seed):
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 2, (B, p.K)).astype(np.int8)
    tx = 1.0 - 2.0 * tpolar.encode(p, torch.as_tensor(pay)).numpy().astype(np.float32)
    sig = np.array([10 ** (-1 / 20)] * 2 + [10 ** (1 / 20)] * 2 + [1.0, 1.0], np.float32)
    y = tx + sig[:, None] * rng.standard_normal(tx.shape).astype(np.float32)
    y[4] = rng.standard_normal(p.E)
    llr = (2 * y / sig[:, None] ** 2).astype(np.float32)
    llr[5] = 0.0
    return pay, llr


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    """The JAX package's SCL candidates, metrics and decode_with_crc for one
    code on _inputs (one program)."""
    kw, crc = CODES[name]
    p = jpolar.polar_params(**kw)
    _, llr = _inputs(tpolar.polar_params(**kw), list(CODES).index(name))
    (cands, metrics), (sel, ok) = _compiled(
        lambda x: (jpolar.scl_decode(p, jpolar.rate_recover_llr(p, x), 8),
                   jpolar.decode_with_crc(p, x, crc, 8)), jnp.asarray(llr))
    return llr, np.asarray(cands), np.asarray(metrics), np.asarray(sel), np.asarray(ok)


@pytest.mark.parametrize("kw", [c[0] for c in CODES.values()] + MORE_PARAMS)
def test_polar_params_match_jax(kw):
    assert tpolar.polar_params(**kw).__dict__ == jpolar.polar_params(**kw).__dict__
    np.testing.assert_array_equal(tpolar.polar_params(**kw).info_positions,
                                  jpolar.polar_params(**kw).info_positions)


def test_polar_transform_matches_jax():
    u = np.random.default_rng(0).integers(0, 2, (5, 256)).astype(np.int8)
    np.testing.assert_array_equal(tpolar.polar_transform(torch.as_tensor(u)).numpy(),
                                  np.asarray(jpolar.polar_transform(jnp.asarray(u))))


@pytest.mark.parametrize("kw", [c[0] for c in CODES.values()] + MORE_PARAMS[:2])
def test_encode_matches_jax(kw):
    """The generator matrix (interleaver, PC register, transform, bit
    selection folded) equals the JAX package's walk over N."""
    p = tpolar.polar_params(**kw)
    pay = np.random.default_rng(p.K).integers(0, 2, (7, p.K)).astype(np.int8)
    got = tpolar.encode(p, torch.as_tensor(pay))
    assert got.dtype == torch.int8
    jp = jpolar.polar_params(**kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        _compiled(lambda x: jpolar.encode(jp, x), jnp.asarray(pay))))


@pytest.mark.parametrize("kw", [c[0] for c in CODES.values()] + MORE_PARAMS)
def test_rate_recover_matches_jax(kw):
    p = tpolar.polar_params(**kw)
    llr = np.random.default_rng(p.E).standard_normal((3, p.E)).astype(np.float32)
    np.testing.assert_array_equal(
        tpolar.rate_recover_llr(p, torch.as_tensor(llr)).numpy(),
        np.asarray(_compiled(lambda x: jpolar.rate_recover_llr(jpolar.polar_params(**kw), x),
                             jnp.asarray(llr))))


@pytest.mark.parametrize("name", list(CODES))
def test_scl_decode_matches_jax(name):
    kw, crc = CODES[name]
    p = tpolar.polar_params(**kw)
    llr, cands, metrics, sel, ok = _jax_decode(name)
    x = torch.as_tensor(llr)
    got_c, got_m = tpolar.scl_decode(p, tpolar.rate_recover_llr(p, x), 8)
    np.testing.assert_array_equal(got_c.numpy(), cands)
    live = metrics < 1e8
    scale = np.abs(metrics[live]).max()
    np.testing.assert_allclose(got_m.numpy(), metrics, rtol=0, atol=1e-4 * scale)
    got_sel, got_ok = tpolar.decode_with_crc(p, x, crc, 8)
    np.testing.assert_array_equal(got_sel.numpy(), sel)
    np.testing.assert_array_equal(got_ok.numpy(), ok)


@pytest.mark.parametrize("name", ["dci", "uci_pc"])
def test_scl_prune_is_stable_on_ties(name):
    """All-zero LLRs (row 5): every branch ties, so the candidates are what a
    stable prune keeps; the punctured positions of the decodable rows tie
    too.  The port keeps the JAX package's paths."""
    kw, _ = CODES[name]
    p = tpolar.polar_params(**kw)
    llr, cands, _, _, _ = _jax_decode(name)
    zero = torch.zeros((1, p.E))
    got, metrics = tpolar.scl_decode(p, tpolar.rate_recover_llr(p, zero), 8)
    np.testing.assert_array_equal(got.numpy()[0], cands[5])
    assert bool((metrics == 0).all())          # every surviving path is a tie
    assert p.mode == "puncturing" and (tpolar.rate_recover_llr(p, torch.as_tensor(llr)) == 0
                                       ).any(dim=-1).all()


def test_schedule_walks_every_leaf():
    for kw, _ in CODES.values():
        p = tpolar.polar_params(**kw)
        ops = tpolar._schedule(p)
        leaves = sum(1 for op in ops if op[0] in ("info", "pc"))
        leaves += sum(op[1] for op in ops if op[0] == "rate0")
        assert leaves == p.N
        assert sum(op[0] == "info" for op in ops) == p.K
        assert sum(op[0] == "pc" for op in ops) == p.n_pc


@pytest.mark.parametrize("K", list(range(1, 12)))
def test_small_block_matches_jax(K):
    rng = np.random.default_rng(K)
    bits = rng.integers(0, 2, (9, K)).astype(np.int8)
    cw = tsb.encode(torch.as_tensor(bits))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jsb.encode(jnp.asarray(bits))))
    llr = ((1 - 2.0 * cw.numpy()) * 2 + 1.5 * rng.standard_normal(cw.shape)).astype(np.float32)
    llr[-1] = rng.standard_normal(32)              # noise only
    got, conf = tsb.decode(torch.as_tensor(llr), K, return_conf=True)
    want, wconf = jsb.decode(jnp.asarray(llr), K, return_conf=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(conf.numpy(), np.asarray(wconf), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tsb.codebook(K), jsb.codebook(K))
