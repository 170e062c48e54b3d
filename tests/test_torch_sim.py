"""The port's link-level simulators (openairinterface5g_tpu_torch/sim) and
what they added to the port, against the JAX package, on the CPU.

* data/tables.py: pusch_dmrs_symbols equal, or both raise, for every
  mapping type, additional position, start symbol and length.
* coding/rate_matching.py: rate_match_tx / rate_match_rx bit-exact, with
  and without a HARQ buffer, fillers, repetition and LBRM.
* sim/channel.py, deterministic: the profiles' delays and powers equal;
  convolve_taps on the JAX package's own taps within 1e-5 of max|rx|;
  doppler_phasor (normalized by its first sample) within 1e-5;
  apply_cfo and apply_phase_noise within 1e-6 (absolute, |rx| up to 4.7).
* sim/channel.py, statistical, from a fixed seed: mean power per delay
  over 4096 draws within 10 % of the profile, the LOS tap's within 10 %,
  add_noise's variance within 2 % of sigma2.
* sim/ulsim.py: build_step at SNR = +inf decodes every round, as the JAX
  package's does; the CLI's lines and pass string (the noise variance is
  held to the JAX expression in test_torch_pusch_more.py).
* ldpctest, ulschsim, dlschsim: the CLIs at a small size.
* sim/autotest.py: the case lists equal the JAX package's (pallas ->
  kernel); every case of the JAX package's lists runs (none is NOT PORTED).
"""
import ast
import functools
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.coding import ldpc as jldpc
from openairinterface5g_tpu.coding import rate_matching as jrm
from openairinterface5g_tpu.data import tables as jtables
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.sim import autotest as jautotest
from openairinterface5g_tpu.sim import channel as jch
from openairinterface5g_tpu.sim import ulsim as julsim
from openairinterface5g_tpu_torch import sim as tsim
from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.coding import rate_matching as trm
from openairinterface5g_tpu_torch.convert import channel_model_from_jax, config_from_jax
from openairinterface5g_tpu_torch.data import tables as ttables
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.ops import ldpc_decoder, pusch_frontend
from openairinterface5g_tpu_torch.sim import (autotest, channel, dlschsim, dlsim, ldpctest,
                                              ulschsim, ulsim)

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = Path(__file__).resolve().parent.parent
PROFILES = ["AWGN", *sorted(jch.TDL_PROFILES)]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# --------------------------------------------------------------------------
# tables, rate matching
# --------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return fn(*args)
    except (ValueError, IndexError) as e:
        return type(e)


def test_pusch_dmrs_symbols_match_jax():
    assert ttables.PUSCH_DMRS_POS_L1 == jtables.PUSCH_DMRS_POS_L1
    n_invalid = 0
    for mapping in ("A", "B"):
        for add_pos in range(4):
            for start in range(14):
                for n in range(1, 15 - start):
                    args = (mapping, add_pos, start, n)
                    want = _outcome(jtables.pusch_dmrs_symbols, *args)
                    assert _outcome(ttables.pusch_dmrs_symbols, *args) == want, args
                    n_invalid += want is ValueError
    assert n_invalid > 0          # type A with ld < 4 raises in both
    assert ttables.pusch_dmrs_symbols("A", 1, 0, 14) == (2, 11)


@pytest.mark.parametrize("bg,Z,F,ncb", [(2, 16, 12, None), (1, 8, 0, None), (1, 8, 6, 320)])
def test_rate_match_matches_jax(bg, Z, F, ncb):
    jg, tg = jldpc.build_graph(bg, Z), tldpc.build_graph(bg, Z)
    rng = np.random.default_rng(bg * 100 + Z + F)
    cw = rng.integers(0, 2, (3, tg.N_full)).astype(np.int8)
    for rv in range(4):
        # E within the buffer, across its wrap, and repeated (E > N)
        for E in (tg.N // 3, tg.N - 5, (tg.N * 7) // 4):
            e = trm.rate_match_tx(tg, torch.as_tensor(cw), rv, E, F, ncb)
            np.testing.assert_array_equal(
                e.numpy(), np.asarray(jrm.rate_match_tx(jg, jnp.asarray(cw), rv, E, F, ncb)))
            llr = rng.standard_normal((3, E)).astype(np.float32)
            harq = rng.standard_normal((3, tg.N_full)).astype(np.float32)
            for h in (None, harq):
                got = trm.rate_match_rx(tg, torch.as_tensor(llr), rv, F,
                                        None if h is None else torch.as_tensor(h))
                want = jrm.rate_match_rx(jg, jnp.asarray(llr), rv, F,
                                         None if h is None else jnp.asarray(h))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# channel: deterministic part
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", PROFILES)
def test_channel_model_matches_jax(name):
    jm = jch.ChannelModel(name, 2, 4, 30.72e6, delay_spread_ns=100.0)
    tm = channel_model_from_jax(jm)
    assert tm == channel.ChannelModel(name, 2, 4, 30.72e6, delay_spread_ns=100.0)
    np.testing.assert_array_equal(tm.tap_delays_samples(), jm.tap_delays_samples())
    np.testing.assert_array_equal(tm.tap_powers(), jm.tap_powers())
    assert tm.los_power() == jm.los_power()
    assert tm.los_power_normalized() == jm.los_power_normalized()


def test_profile_tables_match_jax():
    assert sorted(channel.TDL_PROFILES) == sorted(jch.TDL_PROFILES)
    for table, jtable in ((channel.TDL_PROFILES, jch.TDL_PROFILES),
                          (channel.LEGACY_PROFILES, jch.LEGACY_PROFILES)):
        for name, (d, p) in jtable.items():
            np.testing.assert_array_equal(table[name][0], d)
            np.testing.assert_array_equal(table[name][1], p)
    assert channel.LOS_COMPONENT == jch.LOS_COMPONENT


@functools.lru_cache(maxsize=None)
def _jax_channels(n_tx: int, n_rx: int):
    """tx and, per profile, the JAX package's (rx, h) from apply_channel: one
    jitted program for all profiles (100 ns at 30.72 MHz merges taps at one
    delay and spans up to 16 samples (EPA) to 30 (TDL-A))."""
    rng = np.random.default_rng(n_rx)
    tx = (rng.standard_normal((2, n_tx, 500)) + 1j * rng.standard_normal((2, n_tx, 500))
          ).astype(np.complex64)
    models = [jch.ChannelModel(name, n_tx, n_rx, 30.72e6, delay_spread_ns=100.0)
              for name in PROFILES]
    # XLA's CPU backend at optimization level 0 compiles it in about half
    # the time
    x = jnp.asarray(tx)
    out = jax.jit(lambda x: [jch.apply_channel(m, jax.random.PRNGKey(k), x)
                             for k, m in enumerate(models)]).lower(x).compile(
        {"xla_backend_optimization_level": 0})(x)
    return tx, {m.name: (m, np.asarray(rx), np.array(h)) for m, (rx, h) in zip(models, out)}


@pytest.mark.parametrize("n_tx,n_rx", [(1, 1), (2, 4)])
@pytest.mark.parametrize("name", PROFILES)
def test_convolve_taps_matches_jax(name, n_tx, n_rx):
    """The port's convolution of JAX's own taps gives JAX's rx."""
    tx, chans = _jax_channels(n_tx, n_rx)
    jm, want, jh = chans[name]
    got = channel.convolve_taps(torch.from_numpy(jh), torch.as_tensor(tx))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    # the port's own draw has JAX's FIR shape
    th = channel.draw_taps(channel_model_from_jax(jm), _gen(n_rx), (2,))
    assert th.shape == jh.shape and th.dtype == torch.complex64


def test_doppler_phasor_matches_jax():
    # the high-speed train at 100 Hz, and a model whose train passes the
    # site within the slot (every piece of the trajectory)
    for f_d, fc in ((100.0, 3.5e9), (300.0, 5e1)):
        jm = jch.ChannelModel("TDLA", 1, 2, 61.44e6, max_doppler_hz=f_d, center_freq_hz=fc)
        want = np.asarray(jch.doppler_phasor(jm, jax.random.PRNGKey(0), 30720))
        got = channel.doppler_phasor(channel_model_from_jax(jm), _gen(0), 30720).numpy()
        assert got.dtype == np.complex64
        np.testing.assert_allclose(np.abs(got), 1.0, atol=1e-6)
        assert np.max(np.abs(got / got[0] - want / want[0])) < 1e-5


def test_cfo_and_phase_noise_match_jax():
    rng = np.random.default_rng(3)
    rx = (rng.standard_normal((2, 2, 15360)) + 1j * rng.standard_normal((2, 2, 15360))
          ).astype(np.complex64)
    for cfo, t0, ph in ((300.0, 0.0, 0.0), (-1234.5, 2e-4, 0.7)):
        want = np.asarray(jch.apply_cfo(jnp.asarray(rx), 30.72e6, cfo, t0, ph))
        got = channel.apply_cfo(torch.as_tensor(rx), 30.72e6, cfo, t0, ph).numpy()
        assert np.max(np.abs(got - want)) < 1e-6
    want = np.asarray(jch.apply_phase_noise(jnp.asarray(rx), 30.72e6))
    got = channel.apply_phase_noise(torch.as_tensor(rx), 30.72e6).numpy()
    assert np.max(np.abs(got - want)) < 1e-6


# --------------------------------------------------------------------------
# channel: statistical part
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["TDLA", "TDLB", "TDLD", "TDLE", "EVA"])
def test_tap_power_per_delay(name):
    """Mean |h|^2 per delay over 4096 draws: the profile's powers of the taps
    at that delay, added (taps that round to one delay must add), and at
    delay 0 of the LOS models the specular power too."""
    m = channel.ChannelModel(name, 1, 1, 30.72e6, delay_spread_ns=100.0)
    h = channel.draw_taps(m, _gen(7), (4096,))[:, 0, 0]        # (4096, L)
    d = m.tap_delays_samples()
    assert len(np.unique(d)) < len(d)                           # some taps merge
    want = np.bincount(d, weights=m.tap_powers(), minlength=h.shape[-1])
    want[0] += m.los_power_normalized()
    got = (h.abs() ** 2).mean(0).double().numpy()
    live = want > 0
    np.testing.assert_allclose(got[live], want[live], rtol=0.10)
    assert np.all(got[~live] == 0)
    assert abs(got.sum() - 1.0) < 0.05


@pytest.mark.parametrize("name", ["TDLD", "TDLE"])
def test_los_component_power(name):
    m = channel.ChannelModel(name, 2, 2, 30.72e6, delay_spread_ns=100.0)
    d = m.tap_delays_samples()
    h0 = channel.draw_taps(m, _gen(11), (4096,))[..., 0]        # (4096, 2, 2)
    want = m.los_power_normalized() + m.tap_powers()[d == 0].sum()
    assert abs(float((h0.abs() ** 2).mean()) - want) < 0.10 * want
    assert m.los_power_normalized() > 0.5 * want               # the LOS part dominates


def test_add_noise_variance():
    rx = torch.zeros((4, 2, 1 << 15), dtype=torch.complex64)
    for sigma2 in (0.5, torch.tensor(3.0)):
        n = channel.add_noise(_gen(5), rx, sigma2)
        assert n.dtype == torch.complex64
        var = float((n.abs() ** 2).mean())
        assert abs(var / float(sigma2) - 1.0) < 0.02
        assert abs(float(n.real.var() / n.imag.var()) - 1.0) < 0.02


# --------------------------------------------------------------------------
# ulsim
# --------------------------------------------------------------------------

def test_noise_variance_at_infinite_snr():
    """SNR = +inf is noiseless (build_step's case below); the variance at
    finite SNRs is held to the JAX expression in test_torch_pusch_more.py."""
    cfg = tpusch.PuschConfig(mu=1, n_prb=6, mcs=9)
    tx = torch.ones((2, 1, 100), dtype=torch.complex64)
    assert float(ulsim.noise_variance(cfg, tx, float("inf"))) == 0.0
    want = cfg.fp.fft_size / cfg.fp.n_sc * 10 ** -0.3
    assert abs(float(ulsim.noise_variance(cfg, tx, 3.0)) - want) <= 1e-6 * want


@pytest.mark.parametrize("n_prb", [6, 24])
def test_build_step_noiseless_decodes(n_prb):
    """Over AWGN at SNR = +inf every round decodes, in the port (the kernel
    decoder's plain version; at 6 PRB the reference decoder too) and, at 6
    PRB, in the JAX package."""
    jcfg = jpusch.PuschConfig(mu=1, n_prb=n_prb, mcs=9, n_rx=2)
    tb = np.random.default_rng(n_prb).integers(0, 2, (2, jcfg.tbs)).astype(np.int8)
    for backend in ("reference", "kernel")[n_prb > 6:]:
        cfg = tpusch.PuschConfig(mu=1, n_prb=n_prb, mcs=9, n_rx=2, decoder_backend=backend)
        step = ulsim.build_step(cfg, 2, 8, "AWGN")
        ok = step(_gen(0), torch.as_tensor(tb), float("inf"))
        assert ok.shape == (2, 2) and ok.dtype == torch.bool and bool(ok.all())
    if n_prb == 6:
        jok = julsim.build_step(jcfg, 2, 8, "AWGN")(
            jax.random.PRNGKey(0), jnp.asarray(tb), jnp.float32(np.inf))
        np.testing.assert_array_equal(np.asarray(jok), ok.numpy())


_ULSIM_LINE = re.compile(
    r"^SNR +-?\d+\.\d\d dB \| BLER \d\.\d{6} \(round0 \d\.\d{6}\) \| avg rounds \d\.\d\d \| "
    r"eff rate \d+\.\d bits/slot \| eff TP \d+\.\d\d% \| \d+ trials in \d+\.\ds$")


def test_ulsim_cli_cpu(capsys):
    n_k1, n_k3 = ldpc_decoder.launches["layered_f32"], pusch_frontend.launches
    rc = ulsim.main(["-R", "6", "-m", "9", "-y", "2", "-g", "TDLA", "--delay-spread", "10",
                     "-M", "2", "-I", "7", "-D", "1", "--chest-window", "16",
                     "-s", "30", "-S", "31", "-n", "3", "--batch", "2",
                     "--backend", "kernel", "--json", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[-1] == "PUSCH test OK"
    assert lines[0].startswith("PUSCH sim: 6 PRB mu=1 MCS 9 (Qm=2 ") and "dmrs=(2, 11)" in lines[0]
    assert lines[1] == "device: cpu, decoder kernel"
    assert _ULSIM_LINE.match(lines[2]), lines[2]
    assert lines[2].startswith("SNR  30.00 dB | BLER 0.000000 (round0 0.000000)")
    res = json.loads(lines[3])       # passed at the first SNR
    assert len(res) == 1 and res[0]["trials"] == 3 and res[0]["eff_throughput_pct"] == 100.0
    # plain versions only on CPU tensors
    assert (ldpc_decoder.launches["layered_f32"], pusch_frontend.launches) == (n_k1, n_k3)


def test_ulsim_sweep_takes_every_flag(monkeypatch):
    """sweep(), the one path from flags to run_sweep (main and
    tools/sim_records.py), passes on every channel flag and the defaults
    of main: snr1 = snr0 + 10, a batch of min(64, trials)."""
    seen = {}
    monkeypatch.setattr(ulsim, "run_sweep", lambda cfg, snrs, n, batch, **kw: seen.update(
        snrs=list(snrs), n=n, batch=batch, **kw) or ([], True))
    args = ulsim.parse_args(["-R", "6", "-s", "2", "-n", "100", "-M", "2", "-I", "7",
                             "-g", "TDLA", "--delay-spread", "10", "-d", "3",
                             "--doppler", "100", "--cfo", "50", "-t", "0"])
    dev = torch.device("cpu")
    assert ulsim.sweep(args, ulsim.config(args), dev, verbose=False) == ([], True)
    assert seen == dict(snrs=[float(s) for s in range(2, 13)], n=100, batch=64, max_rounds=2,
                        n_iters=7, channel="TDLA", eff_tp_check=0.0, verbose=False,
                        delay_spread_ns=10.0, time_shift=3, doppler_hz=100.0, cfo_hz=50.0,
                        device=dev)


def test_ulsim_unported_flags_raise():
    """The flags of PTRS (-T), data on the DMRS symbols (-U ...,1) and the ML
    receiver give their configurations, as the JAX simulator builds them;
    DMRS configuration type 2 stays refused."""
    args = ulsim.parse_args(["-T", "1,2", "-U", "0,2,1,1", "-W", "2", "-y", "2"])
    cfg = ulsim.config(args)
    assert (cfg.ptrs, cfg.ptrs_l, cfg.ptrs_k, cfg.cdm_groups_no_data) == (True, 2, 2, 1)
    assert cfg == config_from_jax(jpusch.PuschConfig(
        mu=1, n_prb=106, mcs=9, n_layers=2, n_rx=2, dmrs_symbols=(2, 7, 11),
        cdm_groups_no_data=1, ptrs=True, ptrs_l=2, ptrs_k=2))
    assert ulsim.config(ulsim.parse_args(["-W", "2", "-y", "2", "--receiver", "ml"])).receiver == "ml"
    with pytest.raises(ValueError, match="type 2"):
        ulsim.config(ulsim.parse_args(["-U", "0,1,2,2"]))


@pytest.mark.parametrize("cli", [ulsim.main, ldpctest.main, ulschsim.main, dlschsim.main,
                                 autotest.main, dlsim.main])
def test_cli_without_cuda_raises(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli([])


# --------------------------------------------------------------------------
# ldpctest, ulschsim, dlschsim
# --------------------------------------------------------------------------

def test_ldpctest_cli_cpu(capsys):
    assert ldpctest.main(["-l", "1024", "-s", "10", "-n", "6", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "LDPC test: block 1024 BG2 Z=104 K=1040 F=16 E=3072 rate 0.333 iters 20"
    assert lines[2].startswith("SNR 10.00 dB: BLER 0.000000 (0/6), decode+encode throughput ")
    p = ldpctest.derive_params(3872)
    assert (p.bg, p.Z, p.K) == (1, 176, 3872)


@pytest.mark.parametrize("cli,label", [(ulschsim.main, "ULSCH"), (dlschsim.main, "DLSCH")])
def test_schsim_cli_cpu(cli, label, capsys):
    assert cli(["-R", "6", "-m", "15", "-s", "14", "-n", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{label} sim: TBS ")
    assert lines[2].startswith("SNR 14.00 dB: BLER 0.000000 (0/3) in ")
    assert lines[-1] == f"{label} test OK"


# --------------------------------------------------------------------------
# autotest
# --------------------------------------------------------------------------

def test_autotest_cases_match_jax():
    def ported(argv):
        return ["kernel" if a == "pallas" else a for a in argv]

    assert autotest.CASES == [(c[0], c[1], ported(c[2]), *c[3:]) for c in jautotest.CASES]
    assert autotest.CONFORMANCE_CASES == [(c, ported(a)) for c, a in jautotest.CONFORMANCE_CASES]
    assert len(autotest.CONFORMANCE_CASES) == 33
    assert all(a[a.index("--backend") + 1] == "kernel" for _, a in autotest.CONFORMANCE_CASES)
    modules = {c[1] for c in autotest.CASES}
    assert modules == {"ldpctest", "ulsim", "dlsim", "ulschsim", "dlschsim", "polartest",
                       "pbchsim", "pucchsim", "prachsim", "lte_dlsim", "lte_ulsim", "nbiotsim",
                       "lte_softmodem_sim"}
    assert autotest.NOT_PORTED == {}
    for m in set(modules) - set(autotest.NOT_PORTED):
        assert (ROOT / "openairinterface5g_tpu_torch/sim" / f"{m}.py").exists()


def test_jax_autotest_imports_only_the_standard_library():
    tree = ast.parse((ROOT / "openairinterface5g_tpu/sim/autotest.py").read_text())
    names = [a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert names and all(n.split(".")[0] in sys.stdlib_module_names for n in names), names


def test_autotest_judges_cases(capsys):
    r = autotest.judge("nbiotsim", "nbiotsim", ["-n", "8"], "NB-IoT test OK", device="cpu")
    assert (r.status, r.item) == ("PASS", None)
    # misc8's branches (PTRS, 3 DMRS symbols carrying data) at 6 PRB, and
    # dlsim's CSI-RS rate matching
    r = autotest.judge("ulsim-misc8", "ulsim", ["-R", "6", "-T", "1,2", "-U", "0,2,1,1", "-s", "20",
                                                "-n", "2", "-t", "99"], "PUSCH test OK", device="cpu")
    assert r.status == "PASS" and r.last_snr_db == 20.0
    r = autotest.judge("dlsim-csirs", "dlsim", ["-R", "6", "-s", "20", "-n", "2", "--csirs",
                                                "-t", "99"], "PDSCH test OK", device="cpu")
    assert r.status == "PASS" and r.last_snr_db == 20.0
    r = autotest.judge("tiny", "ulsim", ["-R", "6", "-s", "20", "-n", "2", "-t", "99"],
                       "PUSCH test OK", device="cpu")
    assert r.status == "PASS" and r.last_snr_db == 20.0
    assert r.first_snr_line.startswith("SNR  20.00 dB | BLER 0.000000")
    autotest.report(r)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[PASS] tiny (") and out[2] == "  passed at 20.00 dB"
    # a case that never meets its gate prints NOK and fails
    r = autotest.judge("fail", "ldpctest", ["-l", "1024", "-s", "-5", "-n", "2", "-i", "2"],
                       "BLER 0.000000", device="cpu")
    assert r.status == "FAIL" and r.last_snr_db == -5.0


def test_autotest_main_counts_not_ported_apart(capsys, monkeypatch):
    assert autotest.main(["--device", "cpu", "--full", "--filter", "nbiotsim"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[PASS] nbiotsim (")
    assert out[-1] == "1/1 autotests passed, 0 not ported"
    # a simulator the port lacked would be listed apart with its item
    monkeypatch.setitem(autotest.NOT_PORTED, "nbiotsim", 8)
    assert autotest.main(["--device", "cpu", "--full", "--filter", "nbiotsim"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[NOT PORTED] nbiotsim (ROADMAP.md Queue 1 item 8)"
    assert out[-1] == "0/0 autotests passed, 1 not ported"


def test_sim_device():
    assert tsim.resolve_device("cpu") == torch.device("cpu")
    assert tsim.device_name(torch.device("cpu")) == "cpu"


# --------------------------------------------------------------------------
# tools/sim_records.py
# --------------------------------------------------------------------------

def test_sim_records_helpers(monkeypatch):
    from openairinterface5g_tpu_torch.tools import sim_records
    # exact intervals: k = 0 and k = n in closed form
    lo, hi = sim_records.clopper_pearson(0, 64)
    assert lo == 0.0 and abs(hi - (1 - 0.005 ** (1 / 64))) < 1e-12
    lo, hi = sim_records.clopper_pearson(64, 64)
    assert hi == 1.0 and abs(lo - 0.005 ** (1 / 64)) < 1e-12
    lo, hi = sim_records.clopper_pearson(32, 64)
    assert abs(lo + hi - 1.0) < 1e-12 and 0.33 < lo < 0.34
    argv = sim_records.curve_argv(["-m", "9", "-R", "106", "-s", "5", "-n", "100", "-t", "99"],
                                  [0.0, 1.0, 2.0])
    args = ulsim.parse_args(argv)
    assert (args.mcs, args.n_prb, args.snr0, args.snr1, args.snr_step, args.n_trials,
            args.eff_tp_check) == (9, 106, 0.0, 2.0, 1.0, sim_records.TRIALS, 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_records.main(["--out-dir", "unused"])


def test_sim_records_ml_pair_config():
    """The ML-against-MMSE pair runs the configuration of
    tests/test_ml_receiver.py at an SNR of BLER_ML_r5.json."""
    from openairinterface5g_tpu_torch.tools import sim_records
    jax_curve = json.loads((ROOT / "BLER_ML_r5.json").read_text())["curve"]
    assert sim_records.ML_SNR_DB in [pt["snr_db"] for pt in jax_curve]
    for receiver in ("linear", "ml"):
        args = ulsim.parse_args([*sim_records.ML_ARGV, "--receiver", receiver])
        cfg = ulsim.config(args)
        assert cfg == config_from_jax(jpusch.PuschConfig(
            mu=1, n_prb=24, mcs=9, n_layers=2, n_rx=2, receiver=receiver))
        assert (args.channel, args.delay_spread, args.n_iters, args.snr0, args.snr1,
                args.n_trials, args.eff_tp_check) == ("TDLA", 100.0, 12, 8.0, 8.0, 256, 0.0)
