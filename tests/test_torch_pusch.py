"""The PUSCH slice of the PyTorch port against the JAX package, on the CPU.

* pusch_tx: complex samples within 1e-5 of the largest magnitude (float32
  FFTs of two libraries), scrambled codeword bits equal.
* pusch_rx through the kernel path of both (frontend and decoder
  "pallas" / "kernel", check_every=1, B=2; JAX in interpret mode, compiled
  by XLA at its CPU optimization level 0): equal tb_ok and tb_bits.  20 PRB gives BG1 Z=384, C=2 and the bf16-staged
  decode; 24 PRB gives Z=320 and the f32 one.
* convert.py: the port's derived configuration values equal the JAX ones.
* The port package and chip_smoke.py import no JAX and nothing of the JAX
  package; its copies of the JAX package's tables, frame parameters and
  TBS helpers equal the originals.  Unported branches raise.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openairinterface5g_tpu.coding import ldpc as jldpc
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.convert import config_from_jax, harq_from_numpy
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.ops import pusch_frontend as tfe

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = Path(__file__).resolve().parent.parent

KERNEL_PATH = dict(decoder_backend="pallas", frontend_backend="pallas", decoder_check_every=1)


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _tb(cfg, B, seed):
    return np.random.default_rng(seed).integers(0, 2, (B, cfg.tbs)).astype(np.int8)


@pytest.mark.parametrize("kw", [
    dict(n_prb=20, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=24, mcs=9, n_layers=1, dmrs_symbols=(2, 11), n_bwp_prb=30, prb_start=4, slot=3),
])
def test_tx_matches_jax(kw):
    jcfg = jpusch.PuschConfig(mu=1, **kw)
    tb = _tb(jcfg, 2, seed=1)
    jtx, jscr = jax.jit(lambda t: jpusch.pusch_tx(jcfg, t))(jnp.asarray(tb))
    ttx, tscr = tpusch.pusch_tx(config_from_jax(jcfg), torch.as_tensor(tb))
    np.testing.assert_array_equal(tscr.numpy(), np.asarray(jscr))
    want = np.asarray(jtx)
    assert ttx.dtype == torch.complex64 and ttx.shape == want.shape
    assert np.max(np.abs(ttx.numpy() - want)) / np.max(np.abs(want)) < 1e-5


def _rx_case(n_prb, seed):
    jcfg = jpusch.PuschConfig(mu=1, n_prb=n_prb, mcs=16, n_layers=2, n_rx=2, **KERNEL_PATH)
    tcfg = config_from_jax(jcfg)
    tb = _tb(jcfg, 2, seed)
    # the port's TX (held to the JAX TX above) + the bench's channel
    tx = tpusch.pusch_tx(tcfg, torch.as_tensor(tb))[0].numpy()
    rng = np.random.default_rng(seed + 1)
    noise = rng.standard_normal((2, *tx.shape)).astype(np.float32)
    rx = (tx + 0.1 * tx[:, ::-1] + 0.05 * (noise[0] + 1j * noise[1])).astype(np.complex64)
    with pltpu.force_tpu_interpret_mode():
        jout = _compiled(lambda r: jpusch.pusch_rx(jcfg, r, n_iters=8), jnp.asarray(rx))
    tout = tpusch.pusch_rx(tcfg, torch.as_tensor(rx), n_iters=8)
    jok = np.asarray(jout["tb_ok"])
    assert jok.all()
    np.testing.assert_array_equal(tout["tb_ok"].numpy(), jok)
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), np.asarray(jout["tb_bits"]))
    np.testing.assert_array_equal(tout["tb_bits"].numpy(), tb)
    np.testing.assert_array_equal(tout["cb_ok"].numpy(), np.asarray(jout["cb_ok"]))
    # the HARQ buffer carries across: same dtype, values within the
    # frontend tolerance (bf16-rounded where staged)
    harq = harq_from_numpy(np.asarray(jout["harq_buffers"]), device="cpu")
    assert harq.dtype == tout["harq_buffers"].dtype and harq.shape == tout["harq_buffers"].shape
    diff = (harq.float() - tout["harq_buffers"].float()).abs().max()
    assert float(diff) <= 1e-2 * float(harq.float().abs().max())
    return tcfg


def test_rx_matches_jax_bf16_path():
    cfg = _rx_case(20, seed=3)
    p, _ = cfg.seg_params()
    assert (p.bg, p.Z, p.C) == (1, 384, 2)


def test_rx_matches_jax_f32_path():
    cfg = _rx_case(24, seed=5)
    assert cfg.seg_params()[0].Z == 320


CONFIGS = [
    dict(n_prb=273, mcs=16, n_layers=2, n_rx=2, decoder_backend="pallas",
         decoder_check_every=1),
    dict(n_prb=20, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=24, mcs=9, n_layers=1, dmrs_symbols=(2, 7, 11)),
    dict(n_prb=51, mcs=27, n_layers=1, n_rx=4, tbs_lbrm=40000, frontend_backend="xla"),
    dict(n_prb=6, mcs=2, n_layers=1, mcs_table=2, n_bwp_prb=10, prb_start=3),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_derived_values(kw):
    jcfg = jpusch.PuschConfig(mu=1, **kw)
    tcfg = config_from_jax(jcfg)
    assert tcfg.decoder_backend == {"xla": "reference", "pallas": "kernel"}[jcfg.decoder_backend]
    assert tcfg.frontend_backend == {"auto": "auto", "xla": "reference"}[jcfg.frontend_backend]
    for f in ("tbs", "G", "qm_rate", "data_symbols", "sc0", "n_data_re"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    # the port's own FrameParams copy: same fields
    assert dataclasses.asdict(tcfg.fp) == dataclasses.asdict(jcfg.fp)
    (tp_, tname), (jp_, jname) = tcfg.seg_params(), jcfg.seg_params()
    assert tp_.__dict__ == jp_.__dict__ and tname == jname
    assert tcfg.ncb() == jcfg.ncb()
    assert tcfg.cb_e_sizes() == jcfg.cb_e_sizes()
    for s in jcfg.dmrs_symbols:
        np.testing.assert_array_equal(tcfg.dmrs_pilot_np(s), jcfg.dmrs_pilot_np(s))
    tg, jg = tldpc.build_graph(tp_.bg, tp_.Z), jldpc.build_graph(jp_.bg, jp_.Z)
    for f in ("tab", "ecol", "eshift", "evalid"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))


def test_harq_from_numpy():
    a = np.random.default_rng(0).standard_normal((2, 3, 40)).astype(np.float32)
    t = harq_from_numpy(a, device="cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    b = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    t = harq_from_numpy(b, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), b.astype(np.float32))


def test_port_imports_no_jax():
    """Every module of the port (tools and simulators included) and
    chip_smoke.py load neither jax nor any module of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import openairinterface5g_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "import openairinterface5g_tpu_torch.tools.bench_ldpc_kernel, openairinterface5g_tpu_torch.ops.tiny\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'openairinterface5g_tpu' or m.startswith('openairinterface5g_tpu.')]\n"
            "assert not bad, bad\n"
            "assert 'openairinterface5g_tpu_torch.tools.bench_overhead' in sys.modules\n"
            "for m in ('sim.channel', 'sim.ulsim', 'sim.dlsim', 'sim.ldpctest', 'sim.ulschsim',\n"
            "          'sim.dlschsim', 'sim.autotest', 'models.pdsch', 'models.csirs',\n"
            "          'phy.ml_detector', 'phy.transform_precoding', 'phy.hopping',\n"
            "          'phy.measurements', 'coding.polar', 'coding.small_block',\n"
            "          'models.pdcch', 'models.pbch', 'models.sync', 'models.pucch',\n"
            "          'models.prach', 'models.uci_on_pusch', 'data.prach_tables',\n"
            "          'sim.polartest', 'sim.smallblocktest', 'sim.pbchsim', 'sim.pucchsim',\n"
            "          'sim.prachsim', 'phy.refsig', 'models.srs', 'models.prs', 'models.mu_mimo',\n"
            "          'models.gnb', 'models.ue', 'data.lte_tables', 'coding.turbo', 'lte.params',\n"
            "          'lte.refsig', 'lte.segmentation', 'lte.rate_matching', 'lte.pdsch',\n"
            "          'lte.pusch', 'sim.lte_dlsim', 'sim.lte_ulsim', 'coding.viterbi', 'lte.pbch',\n"
            "          'lte.pdcch', 'lte.pucch', 'lte.srs', 'lte.prach', 'lte.nbiot', 'lte.mac',\n"
            "          'lte.rrc', 'l3.per', 'runtime.lte_softmodem', 'sim.nbiotsim',\n"
            "          'sim.lte_softmodem_sim', 'runtime.tdd', 'runtime.scheduler',\n"
            "          'runtime.executor', 'runtime.softmodem', 'fapi.messages', 'fapi.transport',\n"
            "          'l2.mac', 'radio.rfsim', 'radio.iqplayer', 'fapi.ue_if', 'runtime.ue_softmodem',\n"
            "          'l2.ue_mac', 'runtime.ra_ota', 'l2.security', 'l2.pdcp', 'l2.rlc', 'l2.sdap',\n"
            "          'l2.userplane', 'runtime.connected_ota', 'fronthaul.if4p5',\n"
            "          'runtime.ru_l1_split', 'l3.rrc', 'l3.nas', 'l3.ngap', 'l3.gtpu', 'l3.f1ap',\n"
            "          'l3.e1ap', 'l3.sctp', 'l3.e2ap', 'l3.xnap', 'l3.x2ap', 'fronthaul.if5',\n"
            "          'fronthaul.oran', 'utils.confmod', 'utils.log', 'utils.ttrace', 'utils.itti',\n"
            "          'utils.telnet', 'utils.vcd', 'utils.webscope', 'utils.profiling',\n"
            "          'parallel.multihost', 'parallel.mesh', 'parallel.collectives',\n"
            "          'parallel.launch', 'parallel.sharded', 'parallel.pusch_sp', 'parallel.dryrun'):\n"
            "    assert 'openairinterface5g_tpu_torch.' + m in sys.modules, m\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_copied_tables_match_jax():
    """data/tables.py and its npz: the port's copies equal the JAX package's."""
    from openairinterface5g_tpu.data import tables as jt
    from openairinterface5g_tpu_torch.data import tables as tt
    assert (ROOT / "openairinterface5g_tpu_torch/data/spec_tables.npz").read_bytes() == \
        (ROOT / "openairinterface5g_tpu/data/spec_tables.npz").read_bytes()
    assert tt.LIFTING_SETS == jt.LIFTING_SETS and tt.ALL_LIFTING_SIZES == jt.ALL_LIFTING_SIZES
    for name in ("BG_INFO_COLS", "BG_ROWS", "BG_COLS", "BG_KCB"):
        assert getattr(tt, name) == getattr(jt, name), name
    for bg in (1, 2):
        for Z in jt.ALL_LIFTING_SIZES:
            assert tt.lifting_set_index(Z) == jt.lifting_set_index(Z)
            np.testing.assert_array_equal(tt.load_base_graph(bg, Z), jt.load_base_graph(bg, Z))
            assert tt.load_base_graph(bg, Z).dtype == jt.load_base_graph(bg, Z).dtype
    with pytest.raises(ValueError):
        tt.lifting_set_index(17)


def test_copied_control_tables_match_jax():
    """The port's copies for the control channels: the polar reliability
    sequence, the PRACH root maps, the bit-serial Gold generator and the
    PSS/SSS/DMRS sequences equal the JAX package's."""
    from openairinterface5g_tpu.data import lte_tables as jlte
    from openairinterface5g_tpu.data import tables as jt
    from openairinterface5g_tpu.phy import hopping as jhop
    from openairinterface5g_tpu.phy import refsig as jrs
    from openairinterface5g_tpu_torch.data import prach_tables as tpt
    from openairinterface5g_tpu_torch.data import tables as tt
    from openairinterface5g_tpu_torch.phy import hopping as thop
    from openairinterface5g_tpu_torch.phy import refsig as trs
    for N in (32, 64, 128, 256, 512, 1024):
        got = tt.polar_reliability_sequence(N)
        np.testing.assert_array_equal(got, jt.polar_reliability_sequence(N))
        assert got.dtype == jt.polar_reliability_sequence(N).dtype
    for bad in (2048, 100):
        with pytest.raises(ValueError):
            tt.polar_reliability_sequence(bad)
    assert tpt.PRACH_ROOT_MAP_0_3 == jlte.PRACH_ROOT_MAP_0_3
    assert tpt.PRACH_ROOT_MAP_4 == jlte.PRACH_ROOT_MAP_4
    for cinit, n in ((0, 8), (41, 300), (0x1234 << 15, 1000), ((1 << 31) - 1, 64)):
        np.testing.assert_array_equal(thop._gold_bits_host(cinit, n), jhop._gold_bits_host(cinit, n))
    for n2 in range(3):
        np.testing.assert_array_equal(trs.pss_sequence(n2), jrs.pss_sequence(n2))
        for n1 in (0, 111, 335):
            np.testing.assert_array_equal(trs.sss_sequence(n1, n2), jrs.sss_sequence(n1, n2))
    for cinit, n in ((5, 144), (123456789, 36)):
        np.testing.assert_array_equal(trs.dmrs_sequence(cinit, n, torch.device("cpu")).numpy(),
                                      np.asarray(jrs.dmrs_sequence(cinit, n)))


def test_copied_transport_matches_jax():
    from openairinterface5g_tpu import transport as jtr
    from openairinterface5g_tpu_torch import transport as ttr
    for table, n_mcs in ((1, 29), (2, 28)):
        for mcs in range(n_mcs):
            qm_r = ttr.mcs_to_qm_rate(mcs, table)
            assert qm_r == jtr.mcs_to_qm_rate(mcs, table)
            for n_prb in (1, 6, 24, 51, 106, 273):
                for n_symb, n_dmrs in ((14, 12), (12, 24), (7, 6), (4, 12)):
                    for layers in (1, 2, 4):
                        args = (qm_r[0], qm_r[1] * 1024, n_prb, n_symb, n_dmrs, 0, layers)
                        assert ttr.compute_tbs(*args) == jtr.compute_tbs(*args), args


def test_copied_frame_params_match_jax():
    from openairinterface5g_tpu import config as jc
    from openairinterface5g_tpu_torch import config as tc
    for mu, n_rb in [*jc.CONFIGS.values(), (0, 25), (0, 270), (2, 66), (2, 132), (3, 32), (3, 66)]:
        t, j = tc.make_frame_params(mu, n_rb), jc.make_frame_params(mu, n_rb)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert tc.fft_size_for_rb(n_rb) == jc.fft_size_for_rb(n_rb)
        for prop in ("scs", "sample_rate", "n_sc", "slots_per_subframe", "slots_per_frame",
                     "cp_samples", "cp0_samples", "samples_per_subframe", "first_carrier"):
            assert getattr(t, prop) == getattr(j, prop), prop
        for slot in range(t.slots_per_subframe + 1):
            np.testing.assert_array_equal(t.cp_lengths(slot), j.cp_lengths(slot))
            np.testing.assert_array_equal(t.symbol_offsets(slot), j.symbol_offsets(slot))
            assert t.samples_per_slot(slot) == j.samples_per_slot(slot)


# PTRS, rm_res, transform precoding, the ML receiver, double-symbol DMRS,
# chest_mode="delay" and cdm_groups_no_data=1 are ported: their parity
# cases are tests/test_torch_pusch_more.py::test_branch_chain_matches_jax
@pytest.mark.parametrize("kw", [dict(decoder_first_iters=2)])
def test_unported_branches_raise(kw):
    cfg = tpusch.PuschConfig(mu=1, n_prb=6, mcs=4, **kw)
    grid = torch.zeros((1, cfg.n_rx, 14, cfg.fp.n_sc), dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpusch.pusch_rx_grid(cfg, grid)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpusch.pusch_tx_grid(cfg, torch.zeros((1, 8), dtype=torch.int8))


def test_uci_and_backend_names_raise():
    # UCI on PUSCH is ported (tests/test_torch_uci.py); like the JAX model it
    # is not combined with the RE map
    from openairinterface5g_tpu_torch.models.uci_on_pusch import UciOnPuschConfig
    cfg = tpusch.PuschConfig(mu=1, n_prb=6, mcs=4, cdm_groups_no_data=1)
    grid = torch.zeros((1, 1, 14, cfg.fp.n_sc), dtype=torch.complex64)
    with pytest.raises(ValueError, match="RE map"):
        tpusch.pusch_rx_grid(cfg, grid, uci_cfg=UciOnPuschConfig())
    for kw in (dict(decoder_backend="pallas"), dict(frontend_backend="xla")):
        with pytest.raises(ValueError):
            tpusch.PuschConfig(**kw)
    # in scope, but outside the kernel's configurations
    cfg3 = tpusch.PuschConfig(mu=1, n_prb=6, mcs=4, n_layers=3, n_rx=4, frontend_backend="kernel")
    with pytest.raises(ValueError):
        tpusch.pusch_frontend(cfg3, torch.zeros((1, 4, 14, cfg3.fp.n_sc), dtype=torch.complex64))


def test_frontend_routing(monkeypatch):
    """auto takes the fused path only for CUDA tensors; kernel always."""
    calls = []
    real = tfe.frontend_planes
    monkeypatch.setattr(tfe, "frontend_planes", lambda c, g: calls.append(1) or real(c, g))
    cfg = tpusch.PuschConfig(mu=1, n_prb=6, mcs=4, n_layers=2, n_rx=2)
    grid = torch.randn((1, 2, 14, cfg.fp.n_sc), dtype=torch.complex64)
    tpusch.pusch_rx_grid(cfg, grid, n_iters=1)
    assert not calls
    tpusch.pusch_rx_grid(dataclasses.replace(cfg, frontend_backend="kernel"), grid, n_iters=1)
    assert calls == [1]
    # quantized LLRs take the codeword-order chain, like the JAX receiver
    tpusch.pusch_rx_grid(dataclasses.replace(cfg, frontend_backend="kernel", llr_quant_bits=8),
                         grid, n_iters=1)
    assert calls == [1, 1]


def test_copied_configs_match_jax():
    from openairinterface5g_tpu import config as jc
    from openairinterface5g_tpu_torch import config as tc
    assert tc.CONFIGS == jc.CONFIGS
    for mu, n_rb in tc.CONFIGS.values():
        assert dataclasses.asdict(tc.make_frame_params(mu, n_rb)) == \
            dataclasses.asdict(jc.make_frame_params(mu, n_rb))
