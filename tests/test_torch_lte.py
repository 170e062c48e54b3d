"""The port's LTE data plane (lte/params, refsig, segmentation,
rate_matching, pdsch, pusch; sim/lte_dlsim, lte_ulsim) against the JAX
package's, on the CPU.

Tolerances:
* frame geometry, host sequences and indices, segmentation, coded and
  scrambled bits, CRC flags, TB bits: equal;
* TX grids and samples: within 1e-6 of their largest magnitude;
* channel estimates: within 1e-5 of their largest magnitude;
* LLRs and de-rate-matched stream LLRs: within 1e-4 of max|LLR| (the
  receive scatter-add may sum repeated positions in another order).

JAX's random streams cannot be reproduced, so each simulator's batch
(``trial``) takes numpy payloads and noise, and so does the JAX
simulator's step written out with the JAX package's functions.  The JAX
turbo decoder compiles a lax.scan per K: the chains run at 6 PRB (one
block, with filler), a two-block TB with both block sizes and filler at
25 PRB, and the autotest cases' 25 PRB in the simulators.  Each JAX TX and
RX is compiled as one program by XLA at its CPU optimization level 0
(eagerly they compile op by op, about six times as long).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.lte import params as jparams
from openairinterface5g_tpu.lte import pdsch as jpdsch
from openairinterface5g_tpu.lte import pusch as jpusch
from openairinterface5g_tpu.lte import rate_matching as jrm
from openairinterface5g_tpu.lte import refsig as jrefsig
from openairinterface5g_tpu.lte import segmentation as jseg
from openairinterface5g_tpu.runtime import tdd as jtdd
from openairinterface5g_tpu_torch.lte import params as tparams
from openairinterface5g_tpu_torch.lte import pdsch as tpdsch
from openairinterface5g_tpu_torch.lte import pusch as tpusch
from openairinterface5g_tpu_torch.lte import rate_matching as trm
from openairinterface5g_tpu_torch.lte import refsig as trefsig
from openairinterface5g_tpu_torch.lte import segmentation as tseg
from openairinterface5g_tpu_torch.sim import autotest, lte_dlsim, lte_ulsim

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TX_TOL = 1e-6
EST_TOL = 1e-5
LLR_TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# --------------------------------------------------------------------------
# params, refsig, segmentation, rate matching
# --------------------------------------------------------------------------

def test_frame_params_match_jax():
    for n_rb in (6, 15, 25, 50, 75, 100):
        t, j = tparams.make_lte_frame_params(n_rb), jparams.make_lte_frame_params(n_rb)
        for k in ("n_rb", "fft_size", "n_sc", "sample_rate", "symbols_per_subframe",
                  "cp_samples", "cp0_samples", "samples_per_subframe", "first_carrier"):
            assert getattr(t, k) == getattr(j, k), (n_rb, k)
        np.testing.assert_array_equal(t.cp_lengths(), j.cp_lengths())
        np.testing.assert_array_equal(t.symbol_offsets(), j.symbol_offsets())
        np.testing.assert_array_equal(tparams._sc_to_bin(t), jparams._sc_to_bin(j))


@pytest.mark.parametrize("n_rb", [6, 25])
def test_ofdm_matches_jax(n_rb):
    """map_to_grid / ofdm_modulate within 1e-6; demodulate and extract of
    JAX's samples within 1e-6 (the grid back)."""
    t, j = tparams.make_lte_frame_params(n_rb), jparams.make_lte_frame_params(n_rb)
    re = _crandn(np.random.default_rng(n_rb), (2, 1, 14, t.n_sc))
    grid = tparams.map_to_grid(t, torch.as_tensor(re))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jparams.map_to_grid(j, jnp.asarray(re))))
    got = tparams.ofdm_modulate(t, grid).numpy()
    want = np.asarray(jparams.ofdm_modulate(j, jnp.asarray(grid.numpy())))
    assert got.shape == (2, 1, t.samples_per_subframe) and _rel(got, want) <= TX_TOL
    back = tparams.extract_from_grid(t, tparams.ofdm_demodulate(t, torch.as_tensor(want.copy())))
    assert _rel(back.numpy(), re) <= TX_TOL


def test_refsig_matches_jax():
    for ns, sym, cell, n_rb in ((2, 0, 0, 25), (3, 4, 17, 6), (19, 0, 503, 100)):
        assert trefsig.crs_cinit(ns, sym, cell) == jrefsig.crs_cinit(ns, sym, cell)
        np.testing.assert_array_equal(trefsig.crs_sequence_np(ns, sym, cell, n_rb),
                                      jrefsig.crs_sequence_np(ns, sym, cell, n_rb))
        for port in (0, 1):
            np.testing.assert_array_equal(trefsig.crs_sc_indices(n_rb, port, sym, cell),
                                          jrefsig.crs_sc_indices(n_rb, port, sym, cell))
    for port in (0, 1, 2, 3):
        assert trefsig.crs_symbols(port) == jrefsig.crs_symbols(port)
    with pytest.raises(ValueError):
        trefsig.crs_v(2, 0)
    for nid2 in range(3):
        np.testing.assert_array_equal(trefsig.pss_sequence_np(nid2), jrefsig.pss_sequence_np(nid2))
        for nid1 in (0, 29, 30, 167):
            for sf in (0, 5):
                np.testing.assert_array_equal(trefsig.sss_sequence_np(nid1, nid2, sf),
                                              jrefsig.sss_sequence_np(nid1, nid2, sf))
    np.testing.assert_array_equal(trefsig.sync_sc_indices(300), jrefsig.sync_sc_indices(300))


def test_segmentation_matches_jax():
    for B in (40, 41, 1192, 6144, 6145, 6232, 12000, 18360, 75400):
        assert dataclasses.astuple(tseg.segment_params(B)) == \
            dataclasses.astuple(jseg.segment_params(B)), B
    p = tseg.segment_params(6232)
    assert (p.C, p.c_minus, p.F) == (2, 1, 56)
    tb = np.random.default_rng(0).integers(0, 2, (3, 6232)).astype(np.int8)
    got = tseg.segment_tb(torch.as_tensor(tb), p)
    want = jseg.segment_tb(jnp.asarray(tb), jseg.segment_params(6232))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tseg.desegment_tb(got, p).numpy(), tb)


def test_rate_matching_matches_jax():
    for K, E, rv, ncb, F in ((40, 100, 0, None, 0), (1216, 3600, 2, None, 24),
                             (3200, 11250, 1, 5000, 0), (3136, 11250, 3, None, 56),
                             (6144, 30000, 0, None, 0)):
        got = trm.turbo_rm_indices(K, E, rv, ncb, F)
        np.testing.assert_array_equal(got, jrm.turbo_rm_indices(K, E, rv, ncb, F))
        if ncb is None:
            np.testing.assert_array_equal(trm.turbo_rm_index_tensor(K, E, rv, F, "cpu").numpy(), got)
    for L, E in ((40, 120), (56, 500), (64, 1920)):
        np.testing.assert_array_equal(trm.conv_rm_indices(L, E), jrm.conv_rm_indices(L, E))
    for G, C, qm in ((22500, 2, 6), (3600, 1, 4), (100000, 13, 6), (7202, 3, 2)):
        assert trm.cb_e_sizes(G, C, qm) == jrm.cb_e_sizes(G, C, qm)
    rng = np.random.default_rng(1)
    K, E, F = 1216, 4000, 24
    idx = jrm.turbo_rm_indices(K, E, 2, F=F)
    d = rng.integers(0, 2, (2, 3 * (K + 4))).astype(np.int8)
    np.testing.assert_array_equal(trm.rate_match_tx(torch.as_tensor(d), idx).numpy(),
                                  np.asarray(jrm.rate_match_tx(jnp.asarray(d), idx)))
    llr = rng.standard_normal((2, E)).astype(np.float32)
    got = trm.rate_match_rx(torch.as_tensor(llr), idx, 3 * (K + 4), F=F, D=K + 4)
    want = jrm.rate_match_rx(jnp.asarray(llr), idx, 3 * (K + 4), F=F, D=K + 4)
    assert _rel(got.numpy(), want) <= LLR_TOL


# --------------------------------------------------------------------------
# PDSCH, PUSCH
# --------------------------------------------------------------------------

_PDSCH = {"pdsch-6prb-2rx": dict(n_rb=6, n_prb=6, mcs=10, n_rx=2),
          "pdsch-2cb-filler": dict(n_rb=25, n_prb=25, mcs=28, tbs_override=6208),
          "pdsch-alloc-2crs": dict(n_rb=25, n_prb=8, prb_start=5, mcs=16, n_ctrl_syms=2,
                                   cell_id=7, n_crs_ports=2, subframe=3)}


def test_pdsch_config_matches_jax():
    for kw in _PDSCH.values():
        t, j = tpdsch.LtePdschConfig(**kw), jpdsch.LtePdschConfig(**kw)
        for a, b in zip(t.data_re_map, j.data_re_map):
            np.testing.assert_array_equal(a, b)
        assert (t.G, t.tbs, t.qm, dataclasses.astuple(t.seg()), t.scrambling_cinit(1)) == \
               (j.G, j.tbs, j.qm, dataclasses.astuple(j.seg()), j.scrambling_cinit(1))
    for mcs in range(29):
        assert tpdsch.lte_mcs_qm(mcs) == jpdsch.lte_mcs_qm(mcs)
    for n_rb, tbs in tpdsch.PEAK_TBS.items():
        assert tpdsch.LtePdschConfig(n_rb=n_rb, n_prb=n_rb).tbs == tbs == jpdsch.PEAK_TBS[n_rb]


def _chain_case(kind, kw, rv, seed):
    """JAX TX and RX of one configuration on shared numpy payloads, with the
    port's outputs beside them: (jax cfg, port cfg, tb, JAX TX, JAX RX out,
    rx samples)."""
    jm, tm = (jpdsch, tpdsch) if kind == "pdsch" else (jpusch, tpusch)
    jcfg = (jm.LtePdschConfig if kind == "pdsch" else jm.LtePuschConfig)(**kw)
    tcfg = (tm.LtePdschConfig if kind == "pdsch" else tm.LtePuschConfig)(**kw)
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, (2, jcfg.tbs)).astype(np.int8)
    return jm, tm, jcfg, tcfg, tb, rng


@pytest.mark.parametrize("case", list(_PDSCH))
def test_pdsch_chain_matches_jax(case):
    """dlsch_encode bits, pdsch_tx samples (within 1e-6) and scrambled bits;
    crs_channel_estimate within 1e-5; pdsch_rx LLRs and stream LLRs within
    1e-4, tb_ok and TB bits equal; a second round combined through
    acc_streams decodes as JAX's does."""
    jm, tm, jcfg, tcfg, tb, rng = _chain_case("pdsch", _PDSCH[case], 0, 7)
    tb_t, tb_j = torch.as_tensor(tb), jnp.asarray(tb)
    np.testing.assert_array_equal(tm.dlsch_encode(tcfg, tb_t, rv=2).numpy(),
                                  np.asarray(_compiled(lambda t: jm.dlsch_encode(jcfg, t, rv=2),
                                                       tb_j)))
    pdcch_row = _crandn(rng, (2, jcfg.fp.n_sc)) if case == "pdsch-6prb-2rx" else None
    got_tx, got_bits = tm.pdsch_tx(tcfg, tb_t, rv=0, pdcch_row=None if pdcch_row is None
                                   else torch.as_tensor(pdcch_row))
    want_tx, want_bits = _compiled(lambda t, row: jm.pdsch_tx(jcfg, t, rv=0, pdcch_row=row),
                                   tb_j, None if pdcch_row is None else jnp.asarray(pdcch_row))
    want_tx = np.asarray(want_tx)
    assert _rel(got_tx.numpy(), want_tx) <= TX_TOL
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    h = (1.0 + 0.3 * _crandn(rng, (1, jcfg.n_rx, 1))).astype(np.complex64)
    rx = (h * want_tx + 0.05 * _crandn(rng, (2, jcfg.n_rx, want_tx.shape[-1]))).astype(np.complex64)
    fp = jcfg.fp
    grid = np.asarray(jparams.extract_from_grid(fp, jparams.ofdm_demodulate(fp, jnp.asarray(rx))))
    got_h, got_nv = tm.crs_channel_estimate(tcfg, torch.as_tensor(grid))
    want_h, want_nv = _compiled(lambda g: jm.crs_channel_estimate(jcfg, g), jnp.asarray(grid))
    assert _rel(got_h.numpy(), want_h) <= EST_TOL and _rel(got_nv.numpy(), want_nv) <= EST_TOL
    got = tm.pdsch_rx(tcfg, torch.as_tensor(rx), rv=0, n_iters=4)
    want = _compiled(lambda r: jm.pdsch_rx(jcfg, r, rv=0, n_iters=4), jnp.asarray(rx))
    _same_rx(got, want)
    np.testing.assert_array_equal(got["tb_bits"].numpy(), tb)
    # a second round, sent at rv 2 through the same channel, added onto the
    # first's streams
    tx2 = np.asarray(_compiled(lambda t: jm.pdsch_tx(jcfg, t, rv=2)[0], tb_j))
    rx2 = (h * tx2 + 0.05 * _crandn(rng, rx.shape)).astype(np.complex64)
    got2 = tm.pdsch_rx(tcfg, torch.as_tensor(rx2), rv=2, n_iters=4, acc_streams=got["streams"])
    want2 = _compiled(lambda r, acc: jm.pdsch_rx(jcfg, r, rv=2, n_iters=4, acc_streams=acc),
                      jnp.asarray(rx2), want["streams"])
    _same_rx(got2, want2)
    np.testing.assert_array_equal(got2["tb_bits"].numpy(), tb)


def _same_rx(got, want):
    assert _rel(got["llrs"].numpy(), want["llrs"]) <= LLR_TOL
    assert len(got["streams"]) == len(want["streams"])
    for g, w in zip(got["streams"], want["streams"]):
        assert _rel(g.numpy(), w) <= LLR_TOL
    for k in ("tb_ok", "cb_ok", "tb_bits"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_pusch_chain_matches_jax():
    """ulsch_encode bits; pusch_tx samples within 1e-6, scrambled bits equal;
    pusch_rx (2 RX) LLRs within 1e-4, TB bits equal; ulsch_decode of the RX
    LLRs equals JAX's."""
    kw = dict(n_rb=6, n_prb=6, mcs=16, n_rx=2, cell_id=11)
    jm, tm, jcfg, tcfg, tb, rng = _chain_case("pusch", kw, 0, 3)
    assert (tcfg.G, tcfg.tbs, tcfg.qm, dataclasses.astuple(tcfg.seg()), tcfg.scrambling_cinit()) \
        == (jcfg.G, jcfg.tbs, jcfg.qm, dataclasses.astuple(jcfg.seg()), jcfg.scrambling_cinit())
    assert tcfg.data_symbols == jcfg.data_symbols
    tb_t, tb_j = torch.as_tensor(tb), jnp.asarray(tb)
    np.testing.assert_array_equal(tm.ulsch_encode(tcfg, tb_t, rv=1).numpy(),
                                  np.asarray(_compiled(lambda t: jm.ulsch_encode(jcfg, t, rv=1),
                                                       tb_j)))
    got_tx, got_bits = tm.pusch_tx(tcfg, tb_t)
    want_tx, want_bits = _compiled(lambda t: jm.pusch_tx(jcfg, t), tb_j)
    want_tx = np.asarray(want_tx)
    assert _rel(got_tx.numpy(), want_tx) <= TX_TOL
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    h = (1.0 + 0.3 * _crandn(rng, (1, 2, 1))).astype(np.complex64)
    rx = (h * want_tx + 0.05 * _crandn(rng, (2, 2, want_tx.shape[-1]))).astype(np.complex64)
    got = tm.pusch_rx(tcfg, torch.as_tensor(rx), n_iters=4)
    want = _compiled(lambda r: jm.pusch_rx(jcfg, r, n_iters=4), jnp.asarray(rx))
    _same_rx(got, want)
    np.testing.assert_array_equal(got["tb_bits"].numpy(), tb)
    dec = tm.ulsch_decode(tcfg, got["llrs"], n_iters=4)
    np.testing.assert_array_equal(dec["tb_bits"].numpy(), tb)


# --------------------------------------------------------------------------
# the simulators
# --------------------------------------------------------------------------

def _jax_trial(cfg, tb, snr_db, noise, n_iters, uplink):
    """JAX's lte_dlsim step on AWGN with the noise given: per round TX, the
    SNR's noise variance, RX with the previous rounds' streams."""
    tx_fn, rx_fn = (jpusch.pusch_tx, jpusch.pusch_rx) if uplink else \
        (jpdsch.pdsch_tx, jpdsch.pdsch_rx)
    oks, acc = [], None
    for r, nz in enumerate(noise):
        rv = lte_dlsim.HARQ_RV_SEQ[r % 4]

        def round_(tb_, nz_, acc_, rv=rv):
            tx, _ = tx_fn(cfg, tb_, rv=rv)
            sig = jnp.mean(jnp.sum(jnp.abs(tx) ** 2, axis=-2))
            sigma2 = sig * (cfg.fp.fft_size / cfg.fp.n_sc) * 10 ** (-snr_db / 10)
            rx = jnp.broadcast_to(tx, nz_.shape) + jnp.sqrt(jnp.float32(sigma2 / 2)) * nz_
            return rx_fn(cfg, rx, rv=rv, n_iters=n_iters, acc_streams=acc_)

        out = _compiled(round_, jnp.asarray(tb), jnp.asarray(nz), acc)
        acc = out["streams"]
        oks.append(np.asarray(out["tb_ok"]))
    return np.stack(oks)


@pytest.mark.parametrize("uplink,argv", [
    (False, ["-m", "10", "-R", "25", "-s", "5"]),
    (True, ["-m", "16", "-R", "25", "-s", "8", "-y", "2"]),
])
def test_sim_trial_matches_jax(uplink, argv):
    """The autotest cases' configurations (lte-dlsim-mcs10, lte-ulsim-mcs16-2rx)
    at an SNR low enough that some trials fail: two HARQ rounds with the same
    numpy payloads and noise give the same per-round tb_ok as JAX's step."""
    args = (lte_ulsim if uplink else lte_dlsim).parse_args(argv)
    kw = dict(n_rb=args.n_rb, n_prb=args.n_rb, mcs=args.mcs, n_rx=args.n_rx)
    jcfg = (jpusch.LtePuschConfig if uplink else jpdsch.LtePdschConfig)(**kw)
    tcfg = (tpusch.LtePuschConfig if uplink else tpdsch.LtePdschConfig)(**kw)
    rng = np.random.default_rng(8)
    B = 4
    tb = rng.integers(0, 2, (B, jcfg.tbs)).astype(np.int8)
    n_samp = jcfg.fp.samples_per_subframe
    noise = [_crandn(rng, (B, args.n_rx, n_samp)) for _ in range(2)]
    eye = torch.ones((B, args.n_rx, 1, 1), dtype=torch.complex64)
    got = lte_dlsim.trial(tcfg, torch.as_tensor(tb), args.snr0, [eye, eye],
                          [torch.as_tensor(n) for n in noise], n_iters=4, uplink=uplink)
    want = _jax_trial(jcfg, tb, args.snr0, noise, 4, uplink)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0].all() and want[1].any()


def test_lte_tdd_counts_match_jax():
    assert lte_dlsim.LTE_TDD_CONFIGS == jtdd.LTE_TDD_CONFIGS
    for c in range(7):
        assert lte_dlsim.lte_tdd_counts(c) == jtdd.lte_tdd_counts(c)


@pytest.mark.parametrize("cli,argv,header,last", [
    (lte_dlsim.main, ["-m", "10", "-R", "6", "-s", "10", "-n", "2", "-M", "2", "-d", "1"],
     "LTE PDSCH sim: 6 PRB MCS 10 (Qm=4) TBS 1168 C=1 channel=AWGN TDD cfg 1 (DL duty 0.56)",
     "LTE PDSCH test OK"),
    (lte_ulsim.main, ["-m", "16", "-R", "6", "-s", "20", "-n", "2", "-y", "2", "-g", "EPA"],
     "LTE PUSCH sim: 6 PRB MCS 16 (Qm=4) TBS 2192 C=1 channel=EPA", "LTE PUSCH test OK"),
])
def test_lte_clis_cpu(cli, argv, header, last, capsys):
    """Exit 0, the JAX simulator's header, SNR line and pass string."""
    assert cli([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == [header, "device: cpu"]
    assert lines[2].startswith(f"SNR {float(argv[argv.index('-s') + 1]):6.2f} dB | BLER 0.000000")
    assert lines[-1] == last


@pytest.mark.parametrize("cli", [lte_dlsim.main, lte_ulsim.main])
def test_lte_clis_without_cuda_raise(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli([])


def test_autotest_runs_lte_cases():
    """Both LTE autotest cases judged on the CPU (fewer trials than listed)."""
    table = {c[0]: c[1:4] for c in autotest.CASES}
    for cid in ("lte-dlsim-mcs10", "lte-ulsim-mcs16-2rx"):
        module, argv, pass_str = table[cid]
        assert module not in autotest.NOT_PORTED
        argv = [*argv[:argv.index("-n") + 1], "4", *argv[argv.index("-n") + 2:]]
        r = autotest.judge(cid, module, argv, pass_str, device="cpu")
        assert r.status == "PASS", r.output
        assert r.first_snr_line.startswith("SNR ")
