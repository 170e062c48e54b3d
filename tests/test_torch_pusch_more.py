"""The port's PUSCH receiver against the JAX package's where the main-path
tests do not reach, on the CPU: 4 layers on two CDM groups (the unfused
chain with zero-forcing), 15 kHz subcarriers (mu = 0), and two HARQ rounds
(rv 0, then rv 2 combined into the first round's buffer).

Both packages take the same received samples: the JAX package's TX, its
own channel (sim/channel.py::apply_channel) and numpy noise of the
port's ulsim noise variance, which must equal the JAX simulator's
expression on the JAX TX.  JAX runs its XLA path (decoder "xla", the unfused
frontend), the port its reference path (decoder "reference", the unfused
frontend, as on every CPU tensor).  In every round tb_ok and tb_bits (of
the TBs that failed too) must be equal, and the HARQ buffers within 1e-2
of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.sim import channel as jch
from openairinterface5g_tpu_torch.convert import config_from_jax, harq_from_numpy
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.ops import pusch_frontend
from openairinterface5g_tpu_torch.sim import ulsim


def _compiled(fn, *args, call: bool = True):
    """fn compiled by XLA for args, at its CPU backend's optimization level
    0, which compiles these programs in about half the time; called on
    args (or, with call=False, returned)."""
    exe = jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})
    return exe(*args) if call else exe


def _run_rounds(jcfg, channel: str, snrs_db, seed: int, B: int = 2, n_iters: int = 20):
    """Send the same TBs in len(snrs_db) HARQ rounds (rv 0, 2, ...) through
    both receivers; returns the per-round (JAX tb_ok, port output)."""
    tcfg = config_from_jax(jcfg)
    assert tcfg.decoder_backend == "reference" and jcfg.decoder_backend == "xla"
    tb = np.random.default_rng(seed).integers(0, 2, (B, jcfg.tbs)).astype(np.int8)
    model = jch.ChannelModel(channel, jcfg.n_layers, jcfg.n_rx, jcfg.fp.sample_rate,
                             delay_spread_ns=10.0)
    rng = np.random.default_rng(seed + 1)
    jharq = tharq = ch_fn = None
    rounds = []
    for r, (rv, snr_db) in enumerate(zip((0, 2, 3, 1), snrs_db)):
        tx = _compiled(lambda t: jpusch.pusch_tx(jcfg, t, rv=rv)[0], jnp.asarray(tb))
        key = jax.random.PRNGKey(seed + r)
        ch_fn = ch_fn or _compiled(lambda k, x: jch.apply_channel(model, k, x)[0], key, tx,
                                   call=False)
        rx = np.asarray(ch_fn(key, tx))
        # ulsim's noise (per TX antenna, per occupied RE): the port's
        # variance, held to the JAX simulator's expression (ulsim.py:66-67)
        sigma2 = float(ulsim.noise_variance(tcfg, torch.from_numpy(np.array(tx)), snr_db))
        sig = jnp.mean(jnp.sum(jnp.abs(tx) ** 2, axis=-2)) / jcfg.n_layers
        want = float(sig * (jcfg.fp.fft_size / jcfg.fp.n_sc) * 10 ** (-jnp.float32(snr_db) / 10))
        assert abs(sigma2 - want) <= 1e-6 * want
        n = rng.standard_normal((2, *rx.shape)).astype(np.float32)
        rx = (rx + np.sqrt(sigma2 / 2) * (n[0] + 1j * n[1])).astype(np.complex64)
        jout = _compiled(lambda y, h: jpusch.pusch_rx(jcfg, y, rv=rv, n_iters=n_iters,
                                                      harq_buffers=h), jnp.asarray(rx), jharq)
        tout = tpusch.pusch_rx(tcfg, torch.as_tensor(rx), rv=rv, n_iters=n_iters,
                               harq_buffers=tharq)
        jok = np.asarray(jout["tb_ok"])
        np.testing.assert_array_equal(tout["tb_ok"].numpy(), jok)
        np.testing.assert_array_equal(tout["tb_bits"].numpy(), np.asarray(jout["tb_bits"]))
        jharq, tharq = jout["harq_buffers"], tout["harq_buffers"]
        want = harq_from_numpy(np.asarray(jharq), device="cpu")
        assert want.dtype == tharq.dtype and want.shape == tharq.shape
        diff = (want.float() - tharq.float()).abs().max()
        assert float(diff) <= 1e-2 * float(want.float().abs().max())
        rounds.append((jok, tout))
    return tb, rounds


def test_rx_4_layers_two_cdm_groups_matches_jax():
    """mimo-5's receiver: ports 0-3 on both CDM groups, which K3 does not
    take, so the unfused chain with zf_equalize runs on every device."""
    jcfg = jpusch.PuschConfig(mu=1, n_prb=8, mcs=9, n_layers=4, n_rx=4)
    assert not pusch_frontend.supported(config_from_jax(jcfg))
    tb, [(jok, tout)] = _run_rounds(jcfg, "TDLA", (25.0,), seed=10)
    assert jok.all()
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), tb)


def test_rx_15khz_matches_jax():
    """mu = 0 as the nine 15 kHz conformance points run it: MCS 20, 2 RX,
    TDL-A at 10 ns, two DMRS symbols, window 16."""
    jcfg = jpusch.PuschConfig(mu=0, n_prb=6, mcs=20, n_rx=2, dmrs_symbols=(2, 11),
                              chest_window=16)
    assert jcfg.fp.scs == 15_000
    assert pusch_frontend.supported(config_from_jax(jcfg))   # K3 takes it on the card
    tb, [(jok, tout)] = _run_rounds(jcfg, "TDLA", (28.0,), seed=20)
    assert jok.all()
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), tb)


def test_rx_two_harq_rounds_matches_jax():
    """rv 0 at an SNR where a TB fails, then rv 2 combined into the first
    round's buffer: the combined round decodes every TB in both packages."""
    jcfg = jpusch.PuschConfig(mu=1, n_prb=6, mcs=9, n_rx=2, dmrs_symbols=(2, 11),
                              chest_window=16)
    tb, rounds = _run_rounds(jcfg, "TDLA", (-2.0, 0.0), seed=32)
    (jok0, _), (jok1, tout1) = rounds
    assert not jok0.all() and jok1.all()
    np.testing.assert_array_equal(tout1["tb_bits"].numpy(), tb)


# --------------------------------------------------------------------------
# The rest of the chain: PTRS, data on the DMRS symbols, rate-match
# patterns, double-symbol DMRS, delay-domain estimation, DFT-s-OFDM and the
# 2-layer ML receiver.  Each branch from the same inputs through both
# packages on the CPU: the TX grid from numpy TBs within 1e-6 (absolute,
# |RE| <= 1.5); then one received grid (the JAX TX grid through a numpy
# channel: a per-antenna mix with a delay slope, a common phase per symbol
# that PTRS tracks, and numpy noise) into both receivers: channel estimate,
# noise variance and equalized symbols within 1e-5 of their largest
# magnitude, LLRs within 1e-4 of max|LLR| (ML: 1e-3, max-log near-ties in
# f32), decoded bits and tb_ok equal.
# --------------------------------------------------------------------------

from openairinterface5g_tpu.phy import channel_estimation as jce  # noqa: E402
from openairinterface5g_tpu.phy import hopping as jhop  # noqa: E402
from openairinterface5g_tpu.phy import measurements as jmeas  # noqa: E402
from openairinterface5g_tpu.phy import ml_detector as jml  # noqa: E402
from openairinterface5g_tpu.phy import modulation as jmod  # noqa: E402
from openairinterface5g_tpu.phy import refsig as jrefsig  # noqa: E402
from openairinterface5g_tpu.phy import transform_precoding as jtp  # noqa: E402
from openairinterface5g_tpu_torch.phy import channel_estimation as tce  # noqa: E402
from openairinterface5g_tpu_torch.phy import hopping as thop  # noqa: E402
from openairinterface5g_tpu_torch.phy import measurements as tmeas  # noqa: E402
from openairinterface5g_tpu_torch.phy import ml_detector as tml  # noqa: E402
from openairinterface5g_tpu_torch.phy import modulation as tmod  # noqa: E402
from openairinterface5g_tpu_torch.phy import refsig as trefsig  # noqa: E402
from openairinterface5g_tpu_torch.phy import transform_precoding as ttp  # noqa: E402

import pytest  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TX_TOL = 1e-6           # TX grids, absolute
EST_TOL = 1e-5          # estimates, noise variance, equalized symbols: of max |.|
LLR_TOL = 1e-4          # LLRs: of max |LLR|
ML_LLR_TOL = 1e-3       # ML LLRs: of max |LLR|


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# --- numpy copies and small functions against the originals ---------------

@pytest.mark.parametrize("n_prb,k,off", [(6, 2, 0), (25, 4, 3), (273, 2, 11)])
def test_ptrs_sc_indices_match_jax(n_prb, k, off):
    got, want = trefsig.ptrs_sc_indices(n_prb, k, off), jrefsig.ptrs_sc_indices(n_prb, k, off)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("port", range(8))
def test_dmrs_double_weights_match_jax(port):
    for got, want in zip(trefsig.dmrs_type1_port_weights_double(port),
                         jrefsig.dmrs_type1_port_weights_double(port)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length", [36, 72, 150, 1638])
def test_low_papr_sequence_matches_jax(length):
    assert trefsig._largest_prime_below(length) == jrefsig._largest_prime_below(length)
    for u, v in ((0, 0), (7, 1), (29, 0)):
        got, want = trefsig.low_papr_sequence(u, v, length), jrefsig.low_papr_sequence(u, v, length)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_csirs_sequence_matches_jax():
    for slot, sym, n_id in ((0, 6, 0), (3, 9, 7), (19, 13, 1007)):
        c = trefsig.csirs_cinit(slot, sym, n_id)
        assert c == jrefsig.csirs_cinit(slot, sym, n_id)
        np.testing.assert_array_equal(trefsig.csirs_sequence(c, 48),
                                      np.asarray(jrefsig.csirs_sequence(c, 48)))


@pytest.mark.parametrize("mode", ["neither", "enable", "disable"])
def test_group_sequence_uv_matches_jax(mode):
    for hid in (0, 7, 31, 1007):
        for slot in range(20):
            for hop in (0, 1):
                for m_zc in (36, 72):
                    args = (hid, mode, slot, hop, m_zc)
                    assert thop.group_sequence_uv(*args) == jhop.group_sequence_uv(*args), args


def test_delay_domain_denoise_matches_jax():
    hp = _crandn(np.random.default_rng(1), (2, 3, 144))
    want = np.asarray(jce.delay_domain_denoise(jnp.asarray(hp)))
    got = tce.delay_domain_denoise(torch.as_tensor(hp))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < EST_TOL


def test_precode_matches_jax():
    rng = np.random.default_rng(2)
    layers, W = _crandn(rng, (2, 3, 2, 40)), _crandn(rng, (4, 2))
    want = np.asarray(jmod.precode(jnp.asarray(layers), jnp.asarray(W)))
    assert _rel(tmod.precode(torch.as_tensor(layers), W).numpy(), want) < EST_TOL


def test_transform_precoding_matches_jax():
    rng = np.random.default_rng(3)
    x, msc = _crandn(rng, (2, 4 * 72)), 72
    np.testing.assert_allclose(ttp.dft_spread(torch.as_tensor(x), msc).numpy(),
                               np.asarray(jtp.dft_spread(jnp.asarray(x), msc)), atol=1e-6)
    mag = (rng.random((2, 4 * 72)) + 0.1).astype(np.float32)
    wd, wm = jtp.idft_despread(jnp.asarray(x), jnp.asarray(mag), msc)
    gd, gm = ttp.idft_despread(torch.as_tensor(x), torch.as_tensor(mag), msc)
    assert _rel(gd.numpy(), wd) < EST_TOL and _rel(gm.numpy(), wm) < EST_TOL


@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_ml_llrs_match_jax(qm):
    rng = np.random.default_rng(qm)
    B, R, M, S = 2, 2, 6 if qm == 8 else 24, 2
    h, y = _crandn(rng, (B, R, 2, M)), _crandn(rng, (B, R, S, M))
    nvar = np.array([0.5, 2.0], np.float32)
    want = np.asarray(jml.ml_llrs_2layer(jnp.asarray(h), jnp.asarray(y), qm, jnp.asarray(nvar)))
    got = tml.ml_llrs_2layer(torch.as_tensor(h), torch.as_tensor(y), qm, torch.as_tensor(nvar))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < ML_LLR_TOL


def test_measurements_match_jax():
    rng = np.random.default_rng(4)
    h, nv = _crandn(rng, (2, 3, 48)), (rng.random(2) + 0.01).astype(np.float32)
    for f in ("rsrp", "rssi"):
        assert _rel(getattr(tmeas, f)(torch.as_tensor(h)).numpy(),
                    getattr(jmeas, f)(jnp.asarray(h))) < 1e-6
    p = np.abs(h).mean(-1).astype(np.float32)
    assert _rel(tmeas.rsrq(torch.as_tensor(p), torch.as_tensor(p * 3), 48).numpy(),
                jmeas.rsrq(jnp.asarray(p), jnp.asarray(p * 3), 48)) < 1e-6
    snr = tmeas.snr_db(torch.as_tensor(p[:, 0]), torch.as_tensor(nv))
    assert _rel(snr.numpy(), jmeas.snr_db(jnp.asarray(p[:, 0]), jnp.asarray(nv))) < 1e-6
    np.testing.assert_array_equal(tmeas._CQI_SNR_THRESH_DB, jmeas._CQI_SNR_THRESH_DB)
    grid = np.linspace(-10, 30, 401).astype(np.float32)
    np.testing.assert_array_equal(tmeas.cqi_from_snr(torch.as_tensor(grid)).numpy(),
                                  np.asarray(jmeas.cqi_from_snr(jnp.asarray(grid))))


# --- the configuration's derived values ----------------------------------

BRANCHES = {
    # id: (JAX PuschConfig fields, channel: receive antennas mix, per-symbol
    # common phase (rad per symbol), SNR dB)
    "ptrs-L1K2": (dict(n_prb=12, mcs=9, ptrs=True, ptrs_l=1, ptrs_k=2), 0.3, 22.0),
    "ptrs-L4K4-offset-2x2": (dict(n_prb=12, mcs=9, n_layers=2, n_rx=2, ptrs=True, ptrs_l=4,
                                  ptrs_k=4, ptrs_re_offset=5, dmrs_symbols=(2, 11)), 0.03, 25.0),
    "misc8-3dmrs-cdm1-ptrs-2x2": (dict(n_prb=12, mcs=16, n_layers=2, n_rx=2, dmrs_symbols=(2, 7, 11),
                                       cdm_groups_no_data=1, ptrs=True, ptrs_l=2), 0.04, 28.0),
    "cdm1-typeB": (dict(n_prb=8, mcs=9, start_symbol=4, n_symbols=8, dmrs_symbols=(4, 8, 10),
                        cdm_groups_no_data=1), 0.0, 20.0),
    "rm_res": (dict(n_prb=12, mcs=9, n_rx=2, rm_res=tuple((6, m) for m in range(0, 144, 12))
                    + ((9, 3), (9, 4))), 0.0, 20.0),
    "double-dmrs-2x2": (dict(n_prb=12, mcs=9, n_layers=2, n_rx=2, dmrs_symbols=(2, 3),
                             dmrs_max_len=2), 0.0, 24.0),
    "double-dmrs-ports4-5": (dict(n_prb=12, mcs=4, n_layers=2, n_rx=2, dmrs_symbols=(2, 3, 10, 11),
                                  dmrs_max_len=2, dmrs_port0=4), 0.0, 24.0),
    "delay-1layer": (dict(n_prb=12, mcs=9, n_rx=2, chest_mode="delay"), 0.0, 20.0),
    "delay-2x2": (dict(n_prb=12, mcs=9, n_layers=2, n_rx=2, chest_mode="delay",
                       dmrs_symbols=(2, 11)), 0.0, 24.0),
    "dft-s-ofdm": (dict(n_prb=12, mcs=9, transform_precoding=True), 0.0, 20.0),
    "dft-s-ofdm-seq-hopping": (dict(n_prb=24, mcs=9, transform_precoding=True, n_id=7, slot=3,
                                    group_seq_hopping="disable"), 0.0, 20.0),
    "dft-s-ofdm-group-hopping": (dict(n_prb=12, mcs=9, transform_precoding=True, n_id=40,
                                      slot=5, group_seq_hopping="enable"), 0.0, 20.0),
    "ml-2x2": (dict(n_prb=6, mcs=9, n_layers=2, n_rx=2, receiver="ml"), 0.0, 20.0),
}


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_branch_config_matches_jax(case):
    jcfg = jpusch.PuschConfig(mu=1, **BRANCHES[case][0])
    tcfg = config_from_jax(jcfg)
    for f in ("tbs", "G", "n_data_re", "data_symbols", "ptrs_symbol_flags", "uses_re_map"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    np.testing.assert_array_equal(tcfg.ptrs_rel_sc(), jcfg.ptrs_rel_sc())
    if jcfg.uses_re_map:
        for got, want in zip(tcfg.data_re_map(), jcfg.data_re_map()):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    assert tcfg.cb_e_sizes() == jcfg.cb_e_sizes()
    for s in jcfg.dmrs_symbols:
        np.testing.assert_array_equal(tcfg.dmrs_pilot_np(s), jcfg.dmrs_pilot_np(s))
    assert not pusch_frontend.supported(tcfg)          # the unfused chain on every device


def test_data_re_map_at_full_width_matches_jax():
    """misc8's map at 273 PRB: the mask read equals the JAX package's loop."""
    jcfg = jpusch.PuschConfig(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2,
                              dmrs_symbols=(2, 7, 11), cdm_groups_no_data=1, ptrs=True, ptrs_l=2)
    for got, want in zip(config_from_jax(jcfg).data_re_map(), jcfg.data_re_map()):
        np.testing.assert_array_equal(got, want)


# --- the chain, branch by branch ------------------------------------------

def _received_grid(jcfg, grid_tx: np.ndarray, phase_step: float, snr_db: float, seed: int):
    """(B, L, symbols, n_sc) TX grid -> (B, n_rx, symbols, n_sc) RX grid: a
    per-antenna mix of the layers (identity plus 0.2 x random, a delay slope
    of 0.3 samples), a common phase phase_step * symbol, complex noise of
    variance 10^(-snr/10) per RE."""
    rng = np.random.default_rng(seed)
    B, L, S, K = grid_tx.shape
    R = jcfg.n_rx
    H = (np.eye(R, L) + 0.2 * _crandn(rng, (R, L))).astype(np.complex64)
    slope = np.exp(-2j * np.pi * 0.3 * np.arange(K) / jcfg.fp.fft_size).astype(np.complex64)
    rx = np.einsum("rl,blsk->brsk", H, grid_tx) * slope
    rx = rx * np.exp(1j * phase_step * np.arange(S))[:, None]
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    return (rx + sigma * _crandn(rng, rx.shape)).astype(np.complex64)


def _jax_receiver(jcfg, n_iters: int):
    """The JAX package's receiver stages on one grid, compiled once."""
    def run(grid):
        h, nv = jpusch.pusch_channel_estimate(jcfg, grid)
        if jcfg.receiver == "ml":
            x = mag = jnp.zeros(())
        else:
            x, mag = jpusch.pusch_equalize(jcfg, grid, h, nv)
        llr = jpusch.pusch_frontend(jcfg, grid)
        out = jpusch.pusch_decode_codeword(jcfg, llr, n_iters=n_iters)
        return h, nv, x, mag, llr, out["tb_ok"], out["tb_bits"]
    return run


def _branch_case(fields: dict, phase_step: float, snr_db: float, seed: int, B: int = 2,
                 n_iters: int = 12):
    jcfg = jpusch.PuschConfig(mu=1, frontend_backend="xla", **fields)
    tcfg = config_from_jax(jcfg)
    tb = np.random.default_rng(seed).integers(0, 2, (B, jcfg.tbs)).astype(np.int8)
    jgrid, jscr = _compiled(lambda t: jpusch.pusch_tx_grid(jcfg, t), jnp.asarray(tb))
    tgrid, tscr = tpusch.pusch_tx_grid(tcfg, torch.as_tensor(tb))
    np.testing.assert_array_equal(tscr.numpy(), np.asarray(jscr))
    jgrid = np.asarray(jgrid)
    assert tgrid.dtype == torch.complex64 and tgrid.shape == jgrid.shape
    assert np.max(np.abs(tgrid.numpy() - jgrid)) < TX_TOL

    grid = _received_grid(jcfg, jgrid, phase_step, snr_db, seed + 1)
    jh, jnv, jx, jmag, jllr, jok, jbits = _compiled(_jax_receiver(jcfg, n_iters), jnp.asarray(grid))
    tg = torch.as_tensor(grid)
    th, tnv = tpusch.pusch_channel_estimate(tcfg, tg)
    assert _rel(th.numpy(), jh) < EST_TOL and _rel(tnv.numpy(), jnv) < EST_TOL
    if jcfg.receiver != "ml":
        tx_, tmag = tpusch.pusch_equalize(tcfg, tg, th, tnv)
        assert _rel(tx_.numpy(), jx) < EST_TOL and _rel(tmag.numpy(), jmag) < EST_TOL
    tllr = tpusch.pusch_frontend(tcfg, tg)
    tol = ML_LLR_TOL if jcfg.receiver == "ml" else LLR_TOL
    assert _rel(tllr.numpy(), jllr) < tol
    tout = tpusch.pusch_rx_grid(tcfg, tg, n_iters=n_iters)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tout["tb_ok"].numpy(), jok)
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), np.asarray(jbits))
    return tb, jok, tout


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_branch_chain_matches_jax(case):
    fields, phase_step, snr_db = BRANCHES[case]
    tb, jok, tout = _branch_case(fields, phase_step, snr_db, seed=sorted(BRANCHES).index(case))
    assert jok.all()
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), tb)


def test_ptrs_tracking_matters():
    """Without PTRS the common phase of ptrs-L1K2's channel breaks the decode
    in both packages; with it both decode (above)."""
    fields, phase_step, snr_db = BRANCHES["ptrs-L1K2"]
    _, jok, tout = _branch_case({**fields, "ptrs": False}, phase_step, snr_db, seed=50)
    assert not jok.any() and not bool(tout["tb_ok"].any())
