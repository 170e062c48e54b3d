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
