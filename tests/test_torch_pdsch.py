"""The PDSCH slice of the PyTorch port (models/pdsch.py, models/csirs.py,
sim/dlsim.py) against the JAX package, on the CPU.

* pdsch_tx: samples within 1e-5 of max|tx| (float32 FFTs of two
  libraries), scrambled bits equal; pdsch_tx_precoded likewise, for each
  PMI of the 2-TX codebook.
* pdsch_rx on the JAX TX through a numpy channel and noise: tb_ok and
  tb_bits equal (the plain versions of K3 and K1 on the CPU, JAX's XLA
  receiver and decoder).
* The 2-codeword PDSCH (6 layers, 8 RX, double-symbol DMRS ports 0-5,
  q = 0 / 1): TX samples within 1e-5 of max|tx|; the joint estimate within
  1e-5 of max|h|, each codeword's LLRs within 1e-4 of max|LLR|, its bits
  and tb_ok equal.
* models/csirs.py: the CSI-RS grid (1 and 2 ports) equal, the PMI, CQI and
  rate-match pattern equal, the measurements within 1e-5 (relative).
* sim/dlsim.py: its configurations equal the JAX simulator's, the CLI's
  lines and "PDSCH test OK" on --device cpu, a CSI-RS slot noiselessly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.models import csirs as jcsirs
from openairinterface5g_tpu.models import pdsch as jpdsch
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu_torch.convert import config_from_jax
from openairinterface5g_tpu_torch.models import csirs as tcsirs
from openairinterface5g_tpu_torch.models import pdsch as tpdsch
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.ops import ldpc_decoder, pusch_frontend
from openairinterface5g_tpu_torch.sim import dlsim, ulsim

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TX_TOL = 1e-5       # time-domain samples: of max |tx|
EST_TOL = 1e-5      # channel estimates, measurements: of max |.|
LLR_TOL = 1e-4      # LLRs: of max |LLR|


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0 (about
    half the compile time), called on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tb(n, B, seed):
    return np.random.default_rng(seed).integers(0, 2, (B, n)).astype(np.int8)


def _channel(tx: np.ndarray, n_rx: int, snr_db: float, seed: int) -> np.ndarray:
    """(B, n_tx, samples) -> (B, n_rx, samples): identity plus 0.1 x a random
    mix, complex noise of 10^(-snr/10) times the mean sample power per
    occupied subcarrier share (the simulators' SNR per RE, roughly)."""
    rng = np.random.default_rng(seed)
    H = (np.eye(n_rx, tx.shape[1]) + 0.1 * _crandn(rng, (n_rx, tx.shape[1]))).astype(np.complex64)
    rx = np.einsum("rt,bts->brs", H, tx)
    sigma2 = np.mean(np.abs(tx) ** 2) * 10 ** (-snr_db / 10) * 4
    return (rx + np.sqrt(sigma2 / 2) * _crandn(rng, rx.shape)).astype(np.complex64)


# --------------------------------------------------------------------------
# PDSCH
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_prb=12, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=8, mcs=26, mcs_table=2, n_rx=2, dmrs_symbols=(2, 11)),
])
def test_pdsch_round_trip_matches_jax(kw):
    jcfg = jpdsch.PdschConfig(mu=1, **kw)
    tcfg = config_from_jax(jcfg)
    assert type(tcfg) is tpdsch.PdschConfig and pusch_frontend.supported(tcfg)   # K3 on the card
    tb = _tb(jcfg.tbs, 2, seed=kw["n_prb"])
    jtx, jscr = _compiled(lambda t: jpdsch.pdsch_tx(jcfg, t), jnp.asarray(tb))
    ttx, tscr = tpdsch.pdsch_tx(tcfg, torch.as_tensor(tb))
    np.testing.assert_array_equal(tscr.numpy(), np.asarray(jscr))
    assert _rel(ttx.numpy(), jtx) < TX_TOL
    rx = _channel(np.asarray(jtx), jcfg.n_rx, 30.0, seed=1)
    jout = _compiled(lambda r: jpdsch.pdsch_rx(jcfg, r, n_iters=10), jnp.asarray(rx))
    tout = tpdsch.pdsch_rx(tcfg, torch.as_tensor(rx), n_iters=10)
    assert np.asarray(jout["tb_ok"]).all()
    np.testing.assert_array_equal(tout["tb_ok"].numpy(), np.asarray(jout["tb_ok"]))
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), tb)


def test_pdsch_tx_precoded_matches_jax():
    jcfg = jpdsch.PdschConfig(mu=1, n_prb=8, mcs=9, start_symbol=2, n_symbols=12)
    tcfg = config_from_jax(jcfg)
    tb = _tb(jcfg.tbs, 4, seed=3)
    np.testing.assert_array_equal(tcsirs.PMI_CODEBOOK_2TX, jcsirs.PMI_CODEBOOK_2TX)
    for pmi in range(4):
        W = tcsirs.PMI_CODEBOOK_2TX[pmi][:, None]
        jtx, jscr = _compiled(lambda t: jpdsch.pdsch_tx_precoded(jcfg, t, W), jnp.asarray(tb))
        ttx, tscr = tpdsch.pdsch_tx_precoded(tcfg, torch.as_tensor(tb), W)
        assert ttx.shape == (4, 2, jtx.shape[-1])
        np.testing.assert_array_equal(tscr.numpy(), np.asarray(jscr))
        assert _rel(ttx.numpy(), jtx) < TX_TOL


def test_pdsch_2codeword_matches_jax():
    jcfg = jpdsch.Pdsch2CwConfig(mu=1, n_prb=12, mcs0=4, mcs1=9, n_layers=6, n_rx=8)
    tcfg = config_from_jax(jcfg)
    assert tcfg.decoder_backend == "reference"
    (jc0, jc1), (tc0, tc1) = jcfg.cw_cfgs(), tcfg.cw_cfgs()
    for j, t in ((jc0, tc0), (jc1, tc1)):
        assert config_from_jax(j) == t
        assert not pusch_frontend.supported(t)          # double-symbol DMRS: the unfused chain
    tb0, tb1 = _tb(jc0.tbs, 2, seed=5), _tb(jc1.tbs, 2, seed=6)
    jtx = _compiled(lambda a, b: jpdsch.pdsch2cw_tx(jcfg, a, b), jnp.asarray(tb0), jnp.asarray(tb1))
    ttx = tpdsch.pdsch2cw_tx(tcfg, torch.as_tensor(tb0), torch.as_tensor(tb1))
    assert _rel(ttx.numpy(), jtx) < TX_TOL
    rx = _channel(np.asarray(jtx), 8, 25.0, seed=7)

    def jax_rx(r):
        from openairinterface5g_tpu.phy.ofdm import extract_from_grid, ofdm_demodulate
        grid = extract_from_grid(jc0.fp, ofdm_demodulate(jc0.fp, r, 0))
        h, nv = jpusch.pusch_channel_estimate(jc0, grid, n_ports=6)
        x, mag = jpusch.pusch_equalize(jc0, grid, h, nv)
        llrs = [jpusch.pusch_llrs(c, grid, x[:, sl], mag[:, sl], h)
                for c, sl in ((jc0, slice(0, 3)), (jc1, slice(3, 6)))]
        return h, llrs, jpdsch.pdsch2cw_rx(jcfg, r, n_iters=12)

    jh, jllrs, jouts = _compiled(jax_rx, jnp.asarray(rx))
    from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate
    grid = extract_from_grid(tc0.fp, ofdm_demodulate(tc0.fp, torch.as_tensor(rx), 0))
    th, tnv = tpusch.pusch_channel_estimate(tc0, grid, n_ports=6)
    assert th.shape[2] == 6 and _rel(th.numpy(), jh) < EST_TOL
    tx_, tmag = tpusch.pusch_equalize(tc0, grid, th, tnv)
    for c, sl, jllr in ((tc0, slice(0, 3), jllrs[0]), (tc1, slice(3, 6), jllrs[1])):
        assert _rel(tpusch.pusch_llrs(c, grid, tx_[:, sl], tmag[:, sl], th).numpy(), jllr) < LLR_TOL
    touts = tpdsch.pdsch2cw_rx(tcfg, torch.as_tensor(rx), n_iters=12)
    for jout, tout, tb in zip(jouts, touts, (tb0, tb1)):
        assert np.asarray(jout["tb_ok"]).all()
        np.testing.assert_array_equal(tout["tb_ok"].numpy(), np.asarray(jout["tb_ok"]))
        np.testing.assert_array_equal(tout["tb_bits"].numpy(), tb)


def test_pdsch2cw_config_checks():
    with pytest.raises(ValueError, match="5..8 layers"):
        tpdsch.Pdsch2CwConfig(n_layers=4).cw_cfgs()
    with pytest.raises(ValueError):
        tpdsch.Pdsch2CwConfig(decoder_backend="xla").cw_cfgs()
    with pytest.raises(ValueError):                       # PuschConfig's checks hold
        tpdsch.PdschConfig(frontend_backend="pallas")


# --------------------------------------------------------------------------
# CSI-RS and measurements
# --------------------------------------------------------------------------

CSIRS = [dict(n_prb=24, symbol=6, re_offset=0, n_id=7),
         dict(n_prb=24, symbol=9, re_offset=4, n_id=3, slot=5, n_ports=2)]


@pytest.mark.parametrize("kw", CSIRS)
def test_csirs_grid_and_pattern_match_jax(kw):
    jc, tc = jcsirs.CsirsConfig(**kw), tcsirs.CsirsConfig(**kw)
    np.testing.assert_array_equal(tcsirs.csirs_sc_indices(tc), jcsirs.csirs_sc_indices(jc))
    want = np.asarray(jcsirs.csirs_tx_grid(jc, 3, 12 * 30))
    got = tcsirs.csirs_tx_grid(tc, 3, 12 * 30, "cpu")
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)
    for prb_start, n_prb in ((0, 24), (4, 12), (20, 10)):
        jp = jpdsch.PdschConfig(mu=1, n_prb=n_prb, prb_start=prb_start, n_bwp_prb=30)
        assert tcsirs.csirs_rm_pattern(tc, 2, config_from_jax(jp)) == jcsirs.csirs_rm_pattern(jc, 2, jp)


def test_csi_measure_matches_jax():
    rng = np.random.default_rng(8)
    jc, tc = jcsirs.CsirsConfig(**CSIRS[0]), tcsirs.CsirsConfig(**CSIRS[0])
    rows = np.asarray(jcsirs.csirs_tx_grid(jc, 2, 12 * 24))
    y = (rows[:, None] * (1 + 0.3 * _crandn(rng, (2, 3, 1)))
         + 0.05 * _crandn(rng, (2, 3, 12 * 24))).astype(np.complex64)
    want = jcsirs.csi_measure(jc, jnp.asarray(y))
    got = tcsirs.csi_measure(tc, torch.as_tensor(y))
    for k in ("h", "rsrp", "noise_var", "snr_db"):
        assert _rel(got[k].numpy(), want[k]) < EST_TOL, k
    np.testing.assert_array_equal(got["cqi"].numpy(), np.asarray(want["cqi"]))


def test_csi_measure_2port_and_pmi_match_jax():
    rng = np.random.default_rng(9)
    jc, tc = jcsirs.CsirsConfig(**CSIRS[1]), tcsirs.CsirsConfig(**CSIRS[1])
    rows = np.asarray(jcsirs.csirs_tx_grid(jc, 4, 12 * 30))       # (B, 2, n_sc)
    H = _crandn(rng, (4, 2, 2))                                   # (B, n_rx, port)
    y = (np.einsum("brp,bpk->brk", H, rows) + 0.01 * _crandn(rng, (4, 2, 12 * 30))
         ).astype(np.complex64)
    want = jcsirs.csi_measure_2port(jc, jnp.asarray(y))
    got = tcsirs.csi_measure_2port(tc, torch.as_tensor(y))
    for k in ("h", "gain", "noise_var", "snr_db"):
        assert _rel(got[k].numpy(), want[k]) < EST_TOL, k
    for k in ("pmi", "cqi"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["pmi"].dtype == torch.int32
    with pytest.raises(ValueError):
        tcsirs.csi_measure_2port(tcsirs.CsirsConfig(), torch.as_tensor(y))


# --------------------------------------------------------------------------
# dlsim
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["-m", "9", "-R", "106"], ["-m", "26", "-q", "2", "-R", "106"],
                                  ["-m", "9", "-R", "106", "--csirs"],
                                  ["-m", "9", "-R", "24", "-W", "2", "-y", "2", "-D", "1",
                                   "--backend", "kernel"]])
def test_dlsim_config_matches_jax(argv):
    """The JAX simulator's configuration for the same flags (sim/dlsim.py
    builds it inside main; here by the same expression)."""
    args = dlsim.parse_args(argv)
    cfg, csirs_cfg = dlsim.config(args)
    rm_kw = {}
    if args.csirs:
        jcs = jcsirs.CsirsConfig(n_prb=args.n_prb, symbol=6, re_offset=0)
        rm_kw = dict(rm_res=jcsirs.csirs_rm_pattern(
            jcs, 0, jpdsch.PdschConfig(mu=args.mu, n_prb=args.n_prb, mcs=args.mcs)))
        assert csirs_cfg == tcsirs.CsirsConfig(n_prb=args.n_prb, symbol=6, re_offset=0)
    else:
        assert csirs_cfg is None
    jcfg = jpdsch.PdschConfig(mu=args.mu, n_prb=args.n_prb, mcs=args.mcs,
                              mcs_table=args.mcs_table, n_layers=args.n_layers, n_rx=args.n_rx,
                              decoder_backend={"reference": "xla", "kernel": "pallas"}[args.backend],
                              dmrs_symbols=(2, 11) if args.dmrs_add_pos else (2,),
                              chest_window=args.chest_window, **rm_kw)
    assert cfg == config_from_jax(jcfg)
    assert (cfg.tbs, cfg.G) == (jcfg.tbs, jcfg.G)
    assert pusch_frontend.supported(cfg) == (not args.csirs)


def test_dlsim_cli_cpu(capsys):
    n_k1, n_k3 = ldpc_decoder.launches["layered_f32"], pusch_frontend.launches
    rc = dlsim.main(["-R", "6", "-m", "9", "-s", "20", "-S", "21", "-n", "3", "-b", "2",
                     "--csirs", "--backend", "kernel", "--json", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[-1] == "PDSCH test OK"
    assert lines[0].startswith("PDSCH sim: 6 PRB mu=1 MCS 9 (Qm=2 ") and "channel=AWGN" in lines[0]
    assert lines[1] == "device: cpu, decoder kernel"
    assert lines[2].startswith("SNR  20.00 dB | BLER 0.000000 (round0 0.000000)")
    assert len(lines) == 5            # header, device, one SNR line, JSON, verdict
    # plain versions only on CPU tensors
    assert (ldpc_decoder.launches["layered_f32"], pusch_frontend.launches) == (n_k1, n_k3)


def test_build_step_with_csirs_noiseless_decodes():
    """A CSI-RS inside the allocation, which rm_res rate-matches around: every
    round decodes at SNR = +inf."""
    args = dlsim.parse_args(["-R", "6", "-m", "27", "--csirs"])
    cfg, csirs_cfg = dlsim.config(args)
    tb = torch.as_tensor(_tb(cfg.tbs, 2, seed=10))
    gen = torch.Generator()
    gen.manual_seed(0)
    ok = ulsim.build_step(cfg, 2, 8, "AWGN", csirs_cfg=csirs_cfg)(gen, tb, float("inf"))
    assert ok.shape == (2, 2) and bool(ok.all())
