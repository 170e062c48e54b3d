"""The port's NB-IoT core (lte/nbiot.py) and its simulator (sim/nbiotsim.py)
against the JAX package's, on the CPU; cases after tests/test_nbiot.py.

Tolerances: the ids, n_init, bits, ok flags and `detected` equal; TX tiles
within 1e-6 of their largest magnitude; the NPSS, NSSS and NPRACH metrics
within 1e-5 of the reference's largest.  JAX's decoders are compiled as one
program each by XLA at its CPU optimization level 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.lte import nbiot as jnb
from openairinterface5g_tpu.sim import nbiotsim as jsim
from openairinterface5g_tpu_torch.lte import nbiot as tnb
from openairinterface5g_tpu_torch.sim import nbiotsim as tsim

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TX_TOL = 1e-6
EST_TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _noise(rng, shape, s):
    return (s * (rng.normal(size=shape) + 1j * rng.normal(size=shape))).astype(np.complex64)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_npss_nsss_match_jax():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(tnb.npss_tile(), jnb.npss_tile())
    zero = np.zeros((2, 14, 12), np.complex64)
    g = tnb.npss_insert(torch.as_tensor(zero))
    want = np.asarray(jnb.npss_insert(jnp.asarray(zero)))
    assert _rel(g.numpy(), want) <= TX_TOL
    for y in (want + _noise(rng, (2, 14, 12), 0.3), _noise(rng, (2, 14, 12), 0.3)):
        assert _rel(tnb.npss_detect(torch.as_tensor(y)).numpy(),
                    jnb.npss_detect(jnp.asarray(y))) <= EST_TOL
    n_id = 257
    for q in (0, 3):
        np.testing.assert_array_equal(tnb._nsss_seq(n_id, q), jnb._nsss_seq(n_id, q))
    g2 = tnb.nsss_insert(torch.as_tensor(zero), n_id, 0)
    want2 = np.asarray(jnb.nsss_insert(jnp.asarray(zero), n_id, 0))
    assert _rel(g2.numpy(), want2) <= TX_TOL
    y = want2 + _noise(rng, (2, 14, 12), 0.3)
    for ids in (range(250, 265), range(0, 504, 7)):
        best, metric = tnb.nsss_identify(torch.as_tensor(y), ids)
        jbest, jmetric = jnb.nsss_identify(jnp.asarray(y), ids)
        _eq(best, jbest)
        assert _rel(metric.numpy(), jmetric) <= EST_TOL
    assert (best.numpy() != n_id).all() and (tnb.nsss_identify(torch.as_tensor(y),
                                                               range(250, 265))[0] == n_id).all()


def test_npbch_matches_jax():
    """8-repetition combining decodes where one subframe does not, as JAX's."""
    rng = np.random.default_rng(1)
    tcfg, jcfg = tnb.NbConfig(n_id=11, n_reps=8), jnb.NbConfig(n_id=11, n_reps=8)
    mib = rng.integers(0, 2, (4, tnb.MIB_NB_BITS)).astype(np.int8)
    tiles = tnb.npbch_tx(tcfg, torch.as_tensor(mib))
    want = np.asarray(_compiled(lambda m: jnb.npbch_tx(jcfg, m), jnp.asarray(mib)))
    assert _rel(tiles.numpy(), want) <= TX_TOL
    noisy = want + _noise(rng, want.shape, 1.5)
    for n_reps in (8, 1):
        t, j = tnb.NbConfig(n_id=11, n_reps=n_reps), jnb.NbConfig(n_id=11, n_reps=n_reps)
        out = tnb.npbch_rx(t, torch.as_tensor(noisy[:, :n_reps]))
        ref = _compiled(lambda x: jnb.npbch_rx(j, x), jnp.asarray(noisy[:, :n_reps]))
        _eq(out["ok"], ref["ok"])
        _eq(out["mib_bits"], ref["mib_bits"])
    assert not bool(out["ok"].all())


@pytest.mark.parametrize("ul", [False, True], ids=["npdsch", "npusch"])
def test_nbsch_matches_jax(ul):
    """NPDSCH (TBCC) and NPUSCH (turbo): tiles within 1e-6, TB bits and ok
    equal JAX's and the sent bits."""
    rng = np.random.default_rng(2)
    kw = dict(tbs=256, n_sf=2, n_reps=4, rnti=0x2E2, ul=ul)
    tcfg, jcfg = tnb.NbSchConfig(**kw), jnb.NbSchConfig(**kw)
    tb = rng.integers(0, 2, (2, tcfg.tbs)).astype(np.int8)
    tiles = tnb.nbsch_tx(tcfg, torch.as_tensor(tb))
    want = np.asarray(_compiled(lambda b: jnb.nbsch_tx(jcfg, b), jnp.asarray(tb)))
    assert _rel(tiles.numpy(), want) <= TX_TOL
    noisy = want + _noise(rng, want.shape, 0.6)
    out = tnb.nbsch_rx(tcfg, torch.as_tensor(noisy))
    ref = _compiled(lambda x: jnb.nbsch_rx(jcfg, x), jnp.asarray(noisy))
    _eq(out["ok"], ref["ok"])
    _eq(out["tb_bits"], ref["tb_bits"])
    assert bool(out["ok"].all())
    _eq(out["tb_bits"], tb)


def test_nprach_matches_jax():
    rng = np.random.default_rng(3)
    tcfg, jcfg = tnb.NprachConfig(), jnb.NprachConfig()
    for n0 in range(12):
        np.testing.assert_array_equal(tnb.nprach_hop_pattern(tcfg, n0),
                                      jnb.nprach_hop_pattern(jcfg, n0))
    for n0 in (0, 5, 11, None):
        tx = np.zeros((2, 8, 12), np.complex64) if n0 is None else \
            np.asarray(jnb.nprach_tx(jcfg, n0, batch=2))
        if n0 is not None:
            assert _rel(tnb.nprach_tx(tcfg, n0, batch=2).numpy(), tx) <= TX_TOL
        rx = tx + _noise(rng, tx.shape, 0.25)
        out = tnb.nprach_detect(tcfg, torch.as_tensor(rx))
        ref = jnb.nprach_detect(jcfg, jnp.asarray(rx))
        _eq(out["detected"], ref["detected"])
        _eq(out["n_init"], ref["n_init"])
        assert _rel(out["metric"].numpy(), ref["metric"]) <= EST_TOL
        assert bool(out["detected"].all()) == (n0 is not None)


def _opt0(fn):
    """fn with its array arguments compiled as one program at XLA's
    optimization level 0 (its other arguments held static)."""
    def call(*args, **kw):
        pos = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

        def on_arrays(*xs):
            full = list(args)
            for i, x in zip(pos, xs):
                full[i] = x
            return fn(*full, **kw)
        return _compiled(on_arrays, *[args[i] for i in pos])
    return call


def test_nbiotsim_prints_jax_lines(capsys, monkeypatch):
    """The port's simulator draws JAX's numpy stream in JAX's order and
    prints JAX's lines, "NB-IoT test OK" last.  JAX's simulator runs its
    nbiot functions each compiled as one program (op by op it takes about
    5x as long)."""
    assert tsim.main(["-n", "8", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    for name in ("npss_insert", "npss_detect", "nsss_insert", "nsss_identify", "npbch_tx",
                 "npbch_rx", "nbsch_tx", "nbsch_rx", "nprach_tx", "nprach_detect"):
        monkeypatch.setattr(jnb, name, _opt0(getattr(jnb, name)))
    assert jsim.main(["-n", "8"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert got == want and got[-1] == "NB-IoT test OK"


def test_nbiotsim_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsim.main([])
