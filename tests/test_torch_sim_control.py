"""The control-channel simulators of the port (polartest, smallblocktest,
pbchsim, pucchsim, prachsim) against the JAX package's, on the CPU.

JAX's random streams cannot be reproduced, so each simulator's batch step
(``trial``) takes numpy payloads, channel draws and noise, and so does the
JAX simulator's step written out with the JAX package's functions (the
expression of its ``step``, with the draws replaced).  The per-trial error
flags must be equal.  Then each CLI at a small size on the CPU: the JAX
simulator's header, SNR lines and pass string, ``--device cuda`` raising
without CUDA, and the autotest cases judged.  Each JAX step is compiled as
one program by XLA at its CPU optimization level 0 (eagerly it compiles op
by op, several times as long).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.coding import polar as jpolar
from openairinterface5g_tpu.coding import small_block as jsb
from openairinterface5g_tpu.coding.crc import crc_attach as jcrc_attach
from openairinterface5g_tpu.models import pbch as jpbch
from openairinterface5g_tpu.models import prach as jprach
from openairinterface5g_tpu.models import pucch as jpucch
from openairinterface5g_tpu_torch.sim import (autotest, pbchsim, polartest, prachsim, pucchsim,
                                              smallblocktest)

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores


def _jit(fn, *examples):
    """fn compiled for the shapes of the numpy examples by XLA at its CPU
    backend's optimization level 0."""
    args = [jnp.asarray(a) for a in examples]
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def _cplx(rng, shape):
    """Unit-power complex normal draws, complex64."""
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            ).astype(np.complex64)


def _phase(rng, shape):
    return np.exp(2j * np.pi * rng.random(shape)).astype(np.complex64)


def test_polartest_trial_matches_jax():
    args = polartest.parse_args(["-u", "-k", "16", "-E", "240"])
    A, crc, p, mode = polartest.code(args)
    assert (A, crc, mode, p.n_pc) == (16, "6", "UCI", 3)
    rng = np.random.default_rng(0)
    pay = rng.integers(0, 2, (16, A)).astype(np.int8)
    noise = rng.standard_normal((16, p.E)).astype(np.float32)
    jp = jpolar.polar_params(K=p.K, E=p.E, n_max=10, i_il=False, n_pc=3, i_bil=True)

    def step(pay_, noise_, snr_):
        # the JAX simulator's step (sim/polartest.py), its draws replaced
        enc = jpolar.encode(jp, jcrc_attach(pay_, crc))
        sigma = 10 ** (-snr_ / 20)
        y = 1.0 - 2.0 * enc.astype(jnp.float32) + sigma * noise_
        bits, ok = jpolar.decode_with_crc(jp, 2 * y / sigma ** 2, crc, list_size=8)
        return jnp.logical_or(~ok, jnp.any(bits != pay_, axis=-1))

    jstep = _jit(step, pay, noise, np.float32(0.0))
    for snr in (-4.0, 0.0):
        got = polartest.trial(p, crc, torch.as_tensor(pay), torch.as_tensor(noise), snr)
        want = jstep(jnp.asarray(pay), jnp.asarray(noise), jnp.float32(snr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) or snr == 0.0


def test_smallblocktest_trial_matches_jax():
    rng = np.random.default_rng(1)
    for K in (3, 11):
        pay = rng.integers(0, 2, (64, K)).astype(np.int8)
        noise = rng.standard_normal((64, 32)).astype(np.float32)
        got = smallblocktest.trial(torch.as_tensor(pay), torch.as_tensor(noise), -4.0)
        def step(pay_, noise_, K=K):
            sigma = 10 ** (-jnp.float32(-4.0) / 20)
            y = 1.0 - 2.0 * jsb.encode(pay_).astype(jnp.float32) + sigma * noise_
            return jnp.any(jsb.decode(2 * y / sigma ** 2, K) != pay_, axis=-1)

        want = _jit(step, pay, noise)(jnp.asarray(pay), jnp.asarray(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


def test_pbchsim_trial_matches_jax():
    rng = np.random.default_rng(2)
    cfg, jcfg = pbchsim.PbchConfig(n_id=0, i_ssb=0), jpbch.PbchConfig(n_id=0, i_ssb=0)
    pay = rng.integers(0, 2, (16, 32)).astype(np.int8)
    h = _phase(rng, (16, 1, 1, 1))
    noise = _cplx(rng, (16, 1, 4, 240))
    got = pbchsim.trial(cfg, torch.as_tensor(pay), torch.as_tensor(h), torch.as_tensor(noise),
                        -9.0)
    def step(pay_, h_, noise_):
        tile = jpbch.ssb_generate(jcfg, pay_)
        rx = h_ * tile[:, None] + 10 ** (-jnp.float32(-9.0) / 20) * noise_
        bits, ok = jpbch.ssb_receive(jcfg, rx.astype(jnp.complex64), list_size=8)
        return jnp.logical_or(~ok, jnp.any(bits != pay_, axis=-1))

    want = _jit(step, pay, h, noise)(jnp.asarray(pay), jnp.asarray(h), jnp.asarray(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("argv", [["-f", "0", "-b", "2"], ["-f", "1", "-b", "2"],
                                  ["-f", "2", "-b", "6", "-P", "1"],
                                  ["-f", "3", "-b", "11"], ["-f", "4", "-b", "9"]])
def test_pucchsim_trial_matches_jax(argv):
    args = pucchsim.parse_args(argv)
    cfg = pucchsim.config(args)
    jcfg = getattr(jpucch, type(cfg).__name__)(**cfg.__dict__)
    rng = np.random.default_rng(len(argv) + args.format)
    B = 64
    if args.format in (0, 1):
        uci = rng.integers(0, 1 << args.n_bits, B)
    else:
        uci = rng.integers(0, 2, (B, args.n_bits)).astype(np.int8)
    h = _phase(rng, (B, 1, 1, 1))
    noise = _cplx(rng, (B, 1, *pucchsim.tx_shape(cfg)))
    snr = -6.0
    got = pucchsim.trial(cfg, torch.as_tensor(uci), torch.as_tensor(h), torch.as_tensor(noise), snr)
    tx_fn, rx_fn = {0: (jpucch.pucch0_tx, jpucch.pucch0_rx), 1: (jpucch.pucch1_tx, jpucch.pucch1_rx),
                    2: (jpucch.pucch2_tx, jpucch.pucch2_rx)}.get(
        args.format, (jpucch.pucch34_tx, jpucch.pucch34_rx))
    def step(uci_, h_, noise_):
        rx = (h_ * tx_fn(jcfg, uci_)[:, None]
              + 10 ** (-jnp.float32(snr) / 20) * noise_).astype(jnp.complex64)
        out, ok = rx_fn(jcfg, rx)
        if args.format in (0, 1):
            return out != uci_
        return jnp.logical_or(~ok, jnp.any(out != uci_, -1))

    want = _jit(step, uci, h, noise)(jnp.asarray(uci), jnp.asarray(h), jnp.asarray(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("argv", [["-a", "-R", "25", "-m", "0", "-p", "99"],
                                  ["-a", "-R", "32", "-m", "3", "-c", "52"],
                                  ["-a", "-R", "24", "-c", "4", "-H"]])
def test_prachsim_trial_matches_jax(argv):
    args = prachsim.parse_args(argv)
    cfg, n_pre = prachsim.config(args)
    jcfg = jprach.PrachTdConfig(**cfg.__dict__)
    rng = np.random.default_rng(n_pre)
    B = 32
    pre = rng.integers(0, n_pre, B)
    h = _phase(rng, (B, 1, 1))
    noise = np.sqrt(2) * _cplx(rng, (B, 1, cfg.n_samples))
    snr = -36.0
    got = prachsim.trial(cfg, torch.as_tensor(pre), torch.as_tensor(h), torch.as_tensor(noise),
                         snr, args.n_rb)
    def step(pre_, h_, noise_):
        tx = jprach.prach_td_tx(jcfg, pre_)
        tx_lev = jnp.mean(jnp.abs(tx) ** 2)
        sigma2 = tx_lev * 10 ** (-jnp.float32(snr) / 10) / (12 * args.n_rb / cfg.l_ra)
        rx = (h_ * tx[:, None] + jnp.sqrt(sigma2 / 2) * noise_).astype(jnp.complex64)
        out = jprach.prach_td_rx(jcfg, rx)
        return jnp.logical_or(~out["detected"], out["preamble"] != pre_)

    want = _jit(step, pre, h, noise)(jnp.asarray(pre), jnp.asarray(h), jnp.asarray(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prachsim_config_matches_jax_roots():
    """The roots and preamble count of the CI matrix's configurations, as
    the JAX simulator gathers them."""
    for argv, fmt, restricted in ((["-R", "106"], "A2", 0), (["-R", "106", "-c", "4", "-H"], "0", 1),
                                  (["-R", "66", "-m", "3", "-c", "52", "-H"], "A2", 0)):
        cfg, n_pre = prachsim.config(prachsim.parse_args(argv))
        assert (cfg.fmt, cfg.restricted, n_pre) == (fmt, restricted, 64)
        jc = jprach.PrachTdConfig(**cfg.__dict__)
        assert jc.freq_cfg().preamble_map[:64] == cfg.freq_cfg().preamble_map[:64]


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cli,argv,header,last", [
    (polartest.main, ["-q", "-s", "-6", "-n", "4"],
     "polar test (PBCH): A=32 K=56 E=864 N=512 mode=repetition L=8", None),
    (polartest.main, ["-c", "-k", "40", "-E", "216", "-s", "0", "-n", "4"],
     "polar test (DCI): A=40 K=64 E=216 N=256 mode=puncturing L=8", None),
    (smallblocktest.main, ["-k", "4", "-s", "4", "-n", "32"], "device: cpu", "Small block test OK"),
    (pbchsim.main, ["-s", "-7", "-n", "4"], "PBCH sim: cell 0 E=864 N=512 SCL8 n_rx=1",
     "PBCH test OK"),
    (pucchsim.main, ["-f", "0", "-b", "1", "-s", "-2", "-n", "32"], "PUCCH F0 sim: 1 bits, n_rx=1",
     "PUCCH test OK"),
    (pucchsim.main, ["-f", "3", "-b", "11", "-s", "0", "-S", "2", "-n", "16"],
     "PUCCH F3 sim: 11 bits 4 PRB 14 syms, n_rx=1", "PUCCH test OK"),
    (prachsim.main, ["-a", "-s", "-30", "-S", "-24", "-n", "8", "-p", "63", "-R", "106"],
     "PRACH sim: fmt A2 L_RA=139 N_cs=34 restricted=0 16 roots (64 preambles) fs=46.08 MHz "
     "n_rx=1", "PRACH test OK"),
])
def test_control_clis_cpu(cli, argv, header, last, capsys):
    """Exit 0 (every point at BLER 0, or a point meeting the target), the
    JAX simulator's header and SNR lines, its pass string last."""
    assert cli([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == header
    assert "device: cpu" in lines[:2]
    snr = [ln for ln in lines if ln.startswith(("SNR", "K "))]
    assert snr and ("BLER 0.000000" in snr[-1] or "rate 0.000000" in snr[-1])
    if last:
        assert lines[-1] == last


@pytest.mark.parametrize("cli", [polartest.main, smallblocktest.main, pbchsim.main,
                                 pucchsim.main, prachsim.main])
def test_control_clis_without_cuda_raise(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli([])


def test_autotest_runs_control_cases(capsys):
    """A case of each control simulator judged by the autotest on the CPU
    (fewer trials than the listed ones)."""
    table = {c[0]: c[1:4] for c in autotest.CASES}
    for cid, trials in (("polartest-UCI", "8"), ("pbchsim-m7dB", "8"), ("pucchsim-f0-2bit", "32"),
                        ("prachsim-8-25prb-15kHz", "8")):
        module, argv, pass_str = table[cid]
        argv = [*argv[:argv.index("-n") + 1], trials, *argv[argv.index("-n") + 2:]]
        r = autotest.judge(cid, module, argv, pass_str, device="cpu")
        assert r.status == "PASS", r.output
        assert r.first_snr_line.startswith("SNR ")
