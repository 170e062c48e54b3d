"""The port's SRS, PRS, MU-MIMO and the gNB and UE slot models against the
JAX package's, on the CPU.

Tolerances:
* host patterns, coded and scrambled bits, grants, CRC flags, TB bits, UCI
  and PRACH results, PMIs: equal;
* TX grids and samples: within 1e-6 of their largest magnitude;
* channel estimates: within 1e-5 of their largest magnitude; LLRs within
  1e-4 of max|LLR|;
* SRS SNRs within 1e-3 dB; PRS toa_samples within 1e-3 samples.

The slot models compose channels whose parity the other files hold, so each
JAX slot function runs once, at 24 PRB with one PDU of each kind, in a
module-scoped fixture that the cases share.  The DL slot, the UL slot, the
UL TX and MU-MIMO run as whole programs compiled by XLA at its CPU
optimization level 0; the UE slot reads the grant on the host between its
blind search and its PDSCH receiver, each compiled the same way.  The PUSCH
receivers of the UL slot have both backends pinned (JAX xla, the port
reference); the UE builds its own PdschConfig, whose 'auto' frontend takes
the XLA and reference chains on the CPU on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.config import make_frame_params as jframe
from openairinterface5g_tpu.models import csirs as jcsirs
from openairinterface5g_tpu.models import gnb as jgnb
from openairinterface5g_tpu.models import mu_mimo as jmu
from openairinterface5g_tpu.models import pbch as jpbch
from openairinterface5g_tpu.models import pdcch as jpdcch
from openairinterface5g_tpu.models import pdsch as jpdsch
from openairinterface5g_tpu.models import prach as jprach
from openairinterface5g_tpu.models import prs as jprs
from openairinterface5g_tpu.models import pucch as jpucch
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.models import srs as jsrs
from openairinterface5g_tpu.models import ue as jue
from openairinterface5g_tpu.phy import ofdm as jofdm
from openairinterface5g_tpu.phy import refsig as jrefsig
from openairinterface5g_tpu_torch.config import make_frame_params as tframe
from openairinterface5g_tpu_torch.convert import config_from_jax
from openairinterface5g_tpu_torch.models import csirs as tcsirs
from openairinterface5g_tpu_torch.models import gnb as tgnb
from openairinterface5g_tpu_torch.models import mu_mimo as tmu
from openairinterface5g_tpu_torch.models import pbch as tpbch
from openairinterface5g_tpu_torch.models import pdcch as tpdcch
from openairinterface5g_tpu_torch.models import pdsch as tpdsch
from openairinterface5g_tpu_torch.models import prach as tprach
from openairinterface5g_tpu_torch.models import prs as tprs
from openairinterface5g_tpu_torch.models import pucch as tpucch
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.models import srs as tsrs
from openairinterface5g_tpu_torch.models import ue as tue
from openairinterface5g_tpu_torch.phy import refsig as trefsig

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TX_TOL = 1e-6       # TX grids and samples: of the largest magnitude
EST_TOL = 1e-5      # channel estimates: of the largest magnitude
LLR_TOL = 1e-4      # LLRs: of max |LLR|
SNR_TOL_DB = 1e-3
TOA_TOL = 1e-3      # samples

B = 2
BWP = 24
RNTI = 0x4321


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------------
# refsig additions, SRS, PRS
# --------------------------------------------------------------------------

def test_srs_and_prs_sequences_match_jax():
    for n_prb, comb, u, v, cs in ((24, 2, 0, 0, 0), (48, 4, 7, 1, 3), (272, 2, 29, 0, 6)):
        np.testing.assert_array_equal(trefsig.srs_sequence(n_prb, comb, u, v, cs),
                                      jrefsig.srs_sequence(n_prb, comb, u, v, cs))
        for off in range(comb):
            got = trefsig.srs_sc_indices(n_prb, comb, off)
            want = jrefsig.srs_sc_indices(n_prb, comb, off)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    for slot, sym, n_id in ((0, 2, 0), (3, 13, 1023), (9, 5, 4095)):
        assert trefsig.prs_cinit(slot, sym, n_id) == jrefsig.prs_cinit(slot, sym, n_id)
        cinit = jrefsig.prs_cinit(slot, sym, n_id)
        np.testing.assert_array_equal(trefsig.prs_sequence(cinit, 72),
                                      np.asarray(jrefsig.prs_sequence(cinit, 72)))
    for comb in (2, 4, 6, 12):
        for off in (0, 1, 5):
            np.testing.assert_array_equal(trefsig.prs_staircase_offsets(comb, 14, off),
                                          jrefsig.prs_staircase_offsets(comb, 14, off))


@pytest.mark.parametrize("n_ports,comb", [(1, 2), (2, 4)])
def test_srs_matches_jax(n_ports, comb):
    """srs_tx equal; srs_rx and srs_report on a random channel with noise:
    h within 1e-5, SNRs within 1e-3 dB, CQI (and for 2 ports the PMI) equal."""
    kw = dict(n_prb=24, comb=comb, comb_offset=1, u=5, cyclic_shift=2, n_ports=n_ports)
    jcfg, tcfg = jsrs.SrsConfig(**kw), tsrs.SrsConfig(**kw)
    tx = tsrs.srs_tx(tcfg, B, "cpu")
    assert _rel(tx.numpy(), _compiled(lambda: jsrs.srs_tx(jcfg, B))) <= TX_TOL
    rng = np.random.default_rng(n_ports)
    H = _crandn(rng, (B, 2, n_ports)) / np.sqrt(2)
    rx = np.einsum("brp,bpk->brk", H, tx.numpy()) + 0.05 * _crandn(rng, (B, 2, 12 * 24))
    rx = rx.astype(np.complex64)
    got = tsrs.srs_report(tcfg, torch.as_tensor(rx))
    want = _compiled(lambda x: jsrs.srs_report(jcfg, x), jnp.asarray(rx))
    assert _rel(got["h"].numpy(), want["h"]) <= EST_TOL
    assert _rel(got["noise_var"].numpy(), want["noise_var"]) <= EST_TOL
    for k in ("wideband_snr_db", "subband_snr_db"):
        assert np.max(np.abs(got[k].numpy() - np.asarray(want[k]))) <= SNR_TOL_DB, k
    np.testing.assert_array_equal(got["ul_cqi"].numpy(), np.asarray(want["ul_cqi"]))
    assert ("pmi" in got) == (n_ports == 2)
    if n_ports == 2:
        np.testing.assert_array_equal(got["pmi"].numpy(), np.asarray(want["pmi"]))
        assert _rel(got["pmi_gain"].numpy(), want["pmi_gain"]) <= EST_TOL


def test_prs_matches_jax():
    """The staircase tile equal; toa within 1e-3 samples over fractional
    delays; a wrong PRS ID and an all-zero input (every bin ties: both take
    the first) give the same toa and peak."""
    cfg_kw = dict(n_prb=24, comb_size=4, n_symbols=4, n_id_prs=42)
    jcfg, tcfg = jprs.PrsConfig(**cfg_kw), tprs.PrsConfig(**cfg_kw)
    n_sc, fft = 288, 512
    tile = tprs.prs_tx_grid(tcfg, 1, n_sc, "cpu").numpy()
    assert _rel(tile, jprs.prs_tx_grid(jcfg, 1, n_sc)) <= TX_TOL
    rng = np.random.default_rng(0)
    k = np.arange(n_sc)
    rows = []
    for delay in (0.0, 3.0, 7.25, -2.5, 12.75):
        h = _crandn(rng, (1, 2, 1, 1))
        rows.append(h * tile[:, None] * np.exp(-2j * np.pi * k * delay / fft)
                    + 0.1 * _crandn(rng, (1, 2, 4, n_sc)))
    rows.append(np.zeros((1, 2, 4, n_sc)))
    rx = np.concatenate(rows).astype(np.complex64)
    for jc, tc in ((jcfg, tcfg), (jprs.PrsConfig(**{**cfg_kw, "n_id_prs": 7}),
                                  tprs.PrsConfig(**{**cfg_kw, "n_id_prs": 7}))):
        got = tprs.prs_toa(tc, torch.as_tensor(rx), fft)
        want = _compiled(lambda x, jc=jc: jprs.prs_toa(jc, x, fft), jnp.asarray(rx))
        assert np.max(np.abs(got["toa_samples"].numpy() - np.asarray(want["toa_samples"]))) \
            <= TOA_TOL
        assert _rel(got["peak_power"].numpy(), want["peak_power"]) <= EST_TOL
        assert got["toa_samples"][-1].item() == 0.0
    ta, tb_ = got["toa_samples"][:1], got["toa_samples"][1:2]
    np.testing.assert_array_equal(tprs.rstd(tcfg, ta, tb_).numpy(),
                                  np.asarray(jprs.rstd(jcfg, jnp.asarray(ta), jnp.asarray(tb_))))


# --------------------------------------------------------------------------
# MU-MIMO
# --------------------------------------------------------------------------

def test_mu_pairing_matches_jax():
    assert tmu._ORTHO_PAIRS == jmu._ORTHO_PAIRS
    rng = np.random.default_rng(2)
    for _ in range(20):
        g1, g2 = rng.random(4), rng.random(4)
        assert tmu.mu_pair_select(g1, g2) == jmu.mu_pair_select(g1, g2)
    for c_t, c_j in zip(tmu.mu_cfgs(24, 0x11, 0x22, mcs=16, n_bwp_prb=48),
                        jmu.mu_cfgs(24, 0x11, 0x22, mcs=16, n_bwp_prb=48)):
        assert c_t == config_from_jax(c_j)


def test_mu_mimo_matches_jax():
    """mu_mimo_tx within 1e-6; each UE's mu_mimo_rx through a fixed 2x2
    channel and noise: LLRs within 1e-4, TB bits and tb_ok equal."""
    j1, j2 = jmu.mu_cfgs(24, 0x1001, 0x1002)
    t1, t2 = tmu.mu_cfgs(24, 0x1001, 0x1002)
    rng = np.random.default_rng(4)
    tb1 = rng.integers(0, 2, (B, j1.tbs)).astype(np.int8)
    tb2 = rng.integers(0, 2, (B, j2.tbs)).astype(np.int8)
    got_tx = tmu.mu_mimo_tx(t1, t2, torch.as_tensor(tb1), torch.as_tensor(tb2), 0, 1)
    assert got_tx.dtype == torch.complex64
    got_tx = got_tx.numpy()
    want_tx = np.asarray(_compiled(lambda a, b: jmu.mu_mimo_tx(j1, j2, a, b, 0, 1),
                                   jnp.asarray(tb1), jnp.asarray(tb2)))
    assert _rel(got_tx, want_tx) <= TX_TOL
    for (jc, tc, port, seed) in ((j1, t1, 0, 10), (j2, t2, 1, 20)):
        r = np.random.default_rng(seed)
        H = (np.eye(2) + 0.3 * _crandn(r, (2, 2))).astype(np.complex64)
        rx = np.einsum("rt,bts->brs", H, want_tx)
        rx = (rx + 0.02 * _crandn(r, rx.shape)).astype(np.complex64)
        got = tmu.mu_mimo_rx(tc, port, torch.as_tensor(rx), n_iters=8)
        want = _compiled(lambda x, jc=jc, port=port: jmu.mu_mimo_rx(jc, port, x, n_iters=8),
                         jnp.asarray(rx))
        assert _rel(got["llrs"].numpy(), want["llrs"]) <= LLR_TOL
        np.testing.assert_array_equal(got["tb_ok"].numpy(), np.asarray(want["tb_ok"]))
        np.testing.assert_array_equal(got["tb_bits"].numpy(), np.asarray(want["tb_bits"]))
        assert got["tb_ok"].all()


# --------------------------------------------------------------------------
# gNB and UE slots
# --------------------------------------------------------------------------

def _dl_configs(m):
    """SlotDlConfig of module m (the JAX package or the port): a PDSCH on PRB
    20-23, an SSB on PRB 0-19 at symbol 8, the grant DCI in a 6-PRB CORESET
    at symbol 0 and a CSI-RS over the BWP at symbol 1."""
    pdsch = m["pdsch"].PdschConfig(mu=1, n_prb=4, prb_start=20, n_bwp_prb=BWP, mcs=9, rnti=RNTI,
                                   start_symbol=2, n_symbols=12, dmrs_symbols=(2,))
    g = m["gnb"]
    return pdsch, g.SlotDlConfig(
        mu=1, n_bwp_prb=BWP, pdsch=(pdsch,),
        ssb=g.SsbPdu(m["pbch"].PbchConfig(n_id=0), prb_offset=0, start_symbol=8),
        pdcch=(g.PdcchPdu(m["pdcch"].DciConfig(A=m["ue"].DCI_A, rnti=RNTI, coreset_prb=6,
                                               aggregation_level=1, start_symbol=0)),),
        csirs=(g.CsirsPdu(m["csirs"].CsirsConfig(n_prb=BWP, symbol=1)),))


def _ul_configs(m):
    """SlotUlConfig of module m: a 2-RX PUSCH on PRB 0-15 over symbols 0-12,
    PUCCH F0 on PRB 18 and F2 (6 bits) on PRB 20-21 at symbol 13, a PRACH."""
    pusch = m["pusch"].PuschConfig(mu=1, n_prb=16, n_bwp_prb=BWP, mcs=9, n_symbols=13, n_rx=2,
                                   **m["backends"])
    p0 = m["pucch"].Pucch0Config(n_bits=1)
    p2 = m["pucch"].Pucch2Config(n_bits=6, n_prb=2)
    return pusch, p0, p2, m["gnb"].SlotUlConfig(
        mu=1, n_bwp_prb=BWP, pusch=(pusch,), pucch0=((p0, 18),), pucch2=((p2, 20),),
        prach=(m["prach"].PrachConfig(),))


_JAX = dict(gnb=jgnb, pdsch=jpdsch, pusch=jpusch, pbch=jpbch, pdcch=jpdcch, csirs=jcsirs,
            ue=jue, pucch=jpucch, prach=jprach,
            backends=dict(frontend_backend="xla", decoder_backend="xla"))
_PORT = dict(gnb=tgnb, pdsch=tpdsch, pusch=tpusch, pbch=tpbch, pdcch=tpdcch, csirs=tcsirs,
             ue=tue, pucch=tpucch, prach=tprach,
             backends=dict(frontend_backend="reference", decoder_backend="reference"))


@pytest.fixture(scope="module")
def slots():
    """Each JAX slot function once on shared numpy inputs, and the inputs."""
    rng = np.random.default_rng(5)
    pdsch, dl = _dl_configs(_JAX)
    tb = rng.integers(0, 2, (B, pdsch.tbs)).astype(np.int8)
    mib = rng.integers(0, 2, (B, 32)).astype(np.int8)
    dci = np.tile(jue.encode_grant(mcs=9, prb_start=20, n_prb=4, rv=3), (B, 1))
    dl_tx, dl_bits = _compiled(lambda a, b, c: jgnb.gnb_dl_slot(dl, [a], b, dci_payloads=[c],
                                                                rvs=[3]),
                               jnp.asarray(tb), jnp.asarray(mib), jnp.asarray(dci))
    dl_tx = np.asarray(dl_tx)
    # the UE's grid: the DL slot through a phase and noise
    fp = jframe(1, BWP)
    grid = np.asarray(jofdm.extract_from_grid(fp, jofdm.ofdm_demodulate(fp, jnp.asarray(dl_tx), 0)))
    ue_grid = (grid * np.exp(0.2j) + 0.03 * _crandn(rng, grid.shape)).astype(np.complex64)
    ue = jue.UeConfig(mu=1, n_bwp_prb=BWP, rnti=RNTI, coreset_prb=6)
    rx_grid, search = jpusch.pusch_rx_grid, jue.blind_search
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpusch, "pusch_rx_grid",
                   lambda cfg, g, **kw: _compiled(lambda x: rx_grid(cfg, x, **kw), g))
        mp.setattr(jue, "blind_search",
                   lambda c, *a, **kw: _compiled(lambda x: search(x, *a, **kw), c))
        ue_out = jue.ue_receive_slot(ue, jnp.asarray(ue_grid), n_iters=8)
    # the UL slot: PUSCH + PUCCH F0 and F2 samples, 2 RX, and a PRACH occasion
    pusch, p0, p2, ul = _ul_configs(_JAX)
    tbu = rng.integers(0, 2, (B, pusch.tbs)).astype(np.int8)
    ack = rng.integers(0, 2, B)
    csi = rng.integers(0, 2, (B, 6)).astype(np.int8)

    def ul_tx(tb_, ack_, csi_):
        g = jnp.zeros((B, 1, 14, fp.n_sc), jnp.complex64)
        g = g.at[:, 0, 13, 12 * 18: 12 * 19].set(jpucch.pucch0_tx(p0, ack_)[:, 0])
        g = g.at[:, 0, 13, 12 * 20: 12 * 22].set(jpucch.pucch2_tx(p2, csi_)[:, 0])
        return jpusch.pusch_tx(pusch, tb_)[0] + jofdm.ofdm_modulate(fp, jofdm.map_to_grid(fp, g), 0)

    one = np.asarray(_compiled(ul_tx, jnp.asarray(tbu), jnp.asarray(ack), jnp.asarray(csi)))
    H = np.array([[1.0], [0.4 + 0.5j]], np.complex64)
    ul_rx = (np.einsum("rt,bts->brs", H, one) + 0.01 * _crandn(rng, (B, 2, one.shape[-1])))
    ul_rx = ul_rx.astype(np.complex64)
    pre = np.array([5, 17])
    pf = np.asarray(jprach.prach_tx(jprach.PrachConfig(), jnp.asarray(pre)))[:, None]
    pf = (pf + 0.1 * _crandn(rng, pf.shape)).astype(np.complex64)
    ul_out = _compiled(lambda a, b: jgnb.gnb_ul_slot(ul, a, n_iters=8, prach_freq=b),
                       jnp.asarray(ul_rx), jnp.asarray(pf))
    return dict(tb=tb, mib=mib, dci=dci, dl_tx=dl_tx, dl_bits=np.asarray(dl_bits[0]),
                ue_grid=ue_grid, ue_out=ue_out, tbu=tbu, ack=ack, csi=csi, pre=pre,
                ul_tx_one=one, ul_rx=ul_rx, pf=pf, ul_out=ul_out)


def test_gnb_dl_slot_matches_jax(slots):
    """The composed DL slot (PDSCH at rv 3, SSB, PDCCH, CSI-RS) within 1e-6 of
    JAX's, the scrambled PDSCH bits equal."""
    _, dl = _dl_configs(_PORT)
    tx, bits = tgnb.gnb_dl_slot(dl, [_t(slots["tb"])], _t(slots["mib"]),
                                dci_payloads=[_t(slots["dci"])], rvs=[3])
    assert _rel(tx.numpy(), slots["dl_tx"]) <= TX_TOL
    np.testing.assert_array_equal(bits[0].numpy(), slots["dl_bits"])
    # an SSB alone (the batch from the MIB), and a list of MIBs
    only = dataclasses.replace(dl, pdsch=(), pdcch=(), csirs=())
    tx1, _ = tgnb.gnb_dl_slot(only, [], _t(slots["mib"]))
    tx2, _ = tgnb.gnb_dl_slot(only, [], [_t(slots["mib"])])
    np.testing.assert_array_equal(tx1.numpy(), tx2.numpy())


def test_gnb_dl_slot_checks():
    _, dl = _dl_configs(_PORT)
    with pytest.raises(ValueError, match="empty DL slot"):
        tgnb.gnb_dl_slot(tgnb.SlotDlConfig(mu=1, n_bwp_prb=BWP), [])
    mib = torch.zeros((B, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="mib_payload list length"):
        tgnb.gnb_dl_slot(dataclasses.replace(dl, pdsch=(), pdcch=(), csirs=()), [], [mib, mib])


def test_ue_receive_slot_matches_jax(slots):
    """The UE finds the DCI at the same level, reads the same grant and
    decodes the PDSCH at rv 3 to the same bits; a UE of another RNTI finds
    nothing."""
    want = slots["ue_out"]
    ue = tue.UeConfig(mu=1, n_bwp_prb=BWP, rnti=RNTI, coreset_prb=6)
    got = tue.ue_receive_slot(ue, _t(slots["ue_grid"]), n_iters=8)
    assert got["grant"] == want["grant"] and got["grant"]["rv"] == 3
    np.testing.assert_array_equal(got["dci_found"].numpy(), np.asarray(want["dci_found"]))
    np.testing.assert_array_equal(got["al"].numpy(), np.asarray(want["al"]))
    np.testing.assert_array_equal(got["tb_ok"].numpy(), np.asarray(want["tb_ok"]))
    np.testing.assert_array_equal(got["tb_bits"].numpy(), np.asarray(want["tb_bits"]))
    np.testing.assert_array_equal(got["tb_bits"].numpy(), slots["tb"])
    assert got["cfg"] == config_from_jax(want["cfg"])
    assert _rel(got["harq_buffers"].numpy(), want["harq_buffers"]) <= LLR_TOL
    other = tue.ue_receive_slot(dataclasses.replace(ue, rnti=0x1111), _t(slots["ue_grid"]))
    assert other["grant"] is None and not other["dci_found"].any() and not other["tb_ok"].any()


def test_gnb_ul_slot_matches_jax(slots):
    """The UL slot's indications equal JAX's: PUSCH CRC and bits (and its
    soft buffers within 1e-4), PUCCH F0 / F2 UCI, the PRACH detection."""
    want = slots["ul_out"]
    *_, ul = _ul_configs(_PORT)
    got = tgnb.gnb_ul_slot(ul, _t(slots["ul_rx"]), n_iters=8, prach_freq=_t(slots["pf"]))
    g_crc, w_crc = got["crc_indication"][0], want["crc_indication"][0]
    for k in ("tb_ok", "cb_ok"):
        np.testing.assert_array_equal(g_crc[k].numpy(), np.asarray(w_crc[k]))
    np.testing.assert_array_equal(got["rx_data"][0].numpy(), np.asarray(want["rx_data"][0]))
    np.testing.assert_array_equal(got["rx_data"][0].numpy(), slots["tbu"])
    assert _rel(got["harq"][0].numpy(), want["harq"][0]) <= LLR_TOL
    np.testing.assert_array_equal(got["uci0"][0]["uci"].numpy(), slots["ack"])
    np.testing.assert_array_equal(got["uci0"][0]["uci"].numpy(), np.asarray(want["uci0"][0]["uci"]))
    assert _rel(got["uci0"][0]["metric"].numpy(), want["uci0"][0]["metric"]) <= EST_TOL
    np.testing.assert_array_equal(got["uci2"][0]["uci"].numpy(), slots["csi"])
    for k in ("uci", "ok"):
        np.testing.assert_array_equal(got["uci2"][0][k].numpy(), np.asarray(want["uci2"][0][k]))
    g_ra, w_ra = got["rach_indication"][0], want["rach_indication"][0]
    np.testing.assert_array_equal(g_ra["preamble"].numpy(), slots["pre"])
    for k in ("detected", "preamble", "delay"):
        np.testing.assert_array_equal(g_ra[k].numpy(), np.asarray(w_ra[k]))
    assert tgnb.gnb_ul_slot(ul, _t(slots["ul_rx"]), n_iters=8)["rach_indication"] == []


def test_pucch_tiles_match_jax(slots):
    """_extract_pucch_tile and place_pucch_tile, with and without intra-slot
    hopping, equal JAX's; place_pucch_tile leaves its input as it was."""
    fp = tframe(1, BWP)
    rng = np.random.default_rng(9)
    grid = _crandn(rng, (B, 2, 14, fp.n_sc))
    for kw in (dict(n_symbols=2, start_symbol=12),
               dict(n_symbols=4, start_symbol=10, intra_slot_hopping=True, second_hop_prb=7)):
        jc, tc = jpucch.Pucch0Config(**kw), tpucch.Pucch0Config(**kw)
        got = tgnb._extract_pucch_tile(torch.as_tensor(grid), tc, 3)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jgnb._extract_pucch_tile(jnp.asarray(grid), jc, 3)))
        tile = _crandn(rng, (B, kw["n_symbols"], 12))
        before = torch.as_tensor(grid)
        placed = tgnb.place_pucch_tile(before, torch.as_tensor(tile), tc, 3)
        want = jgnb.place_pucch_tile(jnp.asarray(grid), jnp.asarray(tile), jc, 3)
        np.testing.assert_array_equal(placed.numpy(), np.asarray(want))
        np.testing.assert_array_equal(before.numpy(), grid)


def test_grant_pack_matches_jax():
    assert tue.DCI_A == jue.DCI_A
    rng = np.random.default_rng(1)
    for _ in range(20):
        f = dict(mcs=int(rng.integers(32)), prb_start=int(rng.integers(512)),
                 n_prb=int(rng.integers(512)), rv=int(rng.integers(4)), ndi=int(rng.integers(2)),
                 harq_id=int(rng.integers(16)), bwp=int(rng.integers(4)))
        bits = tue.encode_grant(**f)
        np.testing.assert_array_equal(bits, jue.encode_grant(**f))
        assert tue.decode_grant(bits) == jue.decode_grant(bits) == f
