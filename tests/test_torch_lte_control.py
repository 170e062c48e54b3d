"""The port's LTE control channels (coding/viterbi, lte/pbch, pdcch, pucch,
srs, prach, the PRACH root maps of data/lte_tables) against the JAX
package's, on the CPU.  Cases follow tests/test_viterbi.py,
test_lte_pdcch.py, test_lte_pucch.py, test_lte_prach.py and
test_lte_phy.py::test_lte_pbch_antenna_mask.

Tolerances:
* bits, CRC flags, indices, the CFI and ACK decisions, the ids, preambles,
  masks and levels found, `detected`: equal;
* TX grids and symbols: within 1e-6 of their largest magnitude;
* d_hat, correlation metrics, SRS h, SNR and noise: within 1e-5 of the
  reference's largest magnitude;
* LLRs: within 1e-4 of max|LLR|.

Each JAX function that decodes is compiled as one program by XLA at its CPU
optimization level 0 (``_compiled``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.coding import viterbi as jvit
from openairinterface5g_tpu.data import lte_tables as jtables
from openairinterface5g_tpu.lte import pbch as jpbch
from openairinterface5g_tpu.lte import pdcch as jpdcch
from openairinterface5g_tpu.lte import prach as jprach
from openairinterface5g_tpu.lte import pucch as jpucch
from openairinterface5g_tpu.lte import srs as jsrs
from openairinterface5g_tpu_torch.coding import viterbi as tvit
from openairinterface5g_tpu_torch.data import lte_tables as ttables
from openairinterface5g_tpu_torch.lte import pbch as tpbch
from openairinterface5g_tpu_torch.lte import pdcch as tpdcch
from openairinterface5g_tpu_torch.lte import prach as tprach
from openairinterface5g_tpu_torch.lte import pucch as tpucch
from openairinterface5g_tpu_torch.lte import srs as tsrs

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


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prach_root_maps_match_jax():
    assert ttables.PRACH_ROOT_MAP_0_3 == jtables.PRACH_ROOT_MAP_0_3
    assert ttables.PRACH_ROOT_MAP_4 == jtables.PRACH_ROOT_MAP_4


# --------------------------------------------------------------------------
# Viterbi
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [40, 43, 120])
def test_viterbi_encode_matches_jax(L):
    bits = np.random.default_rng(L).integers(0, 2, (4, L)).astype(np.int8)
    got = tvit.encode(torch.as_tensor(bits))
    _eq(got, _compiled(jvit.encode, jnp.asarray(bits)))
    # tail-biting: the streams round trip through decode
    _eq(tvit.decode(1.0 - 2.0 * got.float()), bits)
    _eq(tvit.triples(tvit.streams(got)), got.numpy())


def _vit_llrs(kind: str, L: int) -> np.ndarray:
    rng = np.random.default_rng(L)
    if kind == "zeros":                       # every metric ties at every step
        return np.zeros((3, 3 * L), np.float32)
    coded = np.asarray(jvit.encode(jnp.asarray(rng.integers(0, 2, (16, L)).astype(np.int8))))
    llr = 2.0 * (1.0 - 2.0 * coded + rng.normal(0, 1.0, coded.shape))
    if kind == "punctured":
        llr[:, rng.random(llr.shape[1]) < 0.3] = 0.0
    if kind == "integer":                     # quantized LLRs: many near-ties
        llr = np.round(llr)
    return llr.astype(np.float32)


@pytest.mark.parametrize("kind,L", [("noisy", 43), ("noisy", 120), ("zeros", 43),
                                    ("punctured", 40), ("integer", 43)])
def test_viterbi_decode_matches_jax(kind, L):
    """Bits equal, including the all-tie all-zero input and ties between
    integer metrics (predecessor 1 only where strictly larger, the lowest
    best end state)."""
    llr = _vit_llrs(kind, L)
    _eq(tvit.decode(torch.as_tensor(llr)), _compiled(jvit.decode, jnp.asarray(llr)))


# --------------------------------------------------------------------------
# PBCH
# --------------------------------------------------------------------------

def test_mib_pack_matches_jax():
    for kw in (dict(n_rb=50, sfn=512, phich_duration=1, phich_resource=2),
               dict(n_rb=100, sfn=1023), dict(n_rb=6, sfn=4, phich_resource=3)):
        bits = tpbch.mib_pack(**kw)
        np.testing.assert_array_equal(bits, jpbch.mib_pack(**kw))
        assert tpbch.mib_unpack(bits) == jpbch.mib_unpack(bits)


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_pbch_matches_jax(ports):
    """TX grids within 1e-6; the RX (4 frames combined, 2 RX) equal in MIB
    bits, ok and the mask found."""
    kw = dict(n_rb=25, cell_id=17, n_tx_ports=ports, n_rx=2)
    tcfg, jcfg = tpbch.LtePbchConfig(**kw), jpbch.LtePbchConfig(**kw)
    for a, b in zip(tcfg.re_map(), jcfg.re_map()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(ports)
    mib = rng.integers(0, 2, (3, 24)).astype(np.int8)
    grids = tpbch.pbch_tx_grids(tcfg, torch.as_tensor(mib))
    want = _compiled(lambda m: jpbch.pbch_tx_grids(jcfg, m), jnp.asarray(mib))
    assert _rel(grids.numpy(), want) <= TX_TOL
    _eq(tpbch.pbch_encode(tcfg, torch.as_tensor(mib)),
        _compiled(lambda m: jpbch.pbch_encode(jcfg, m), jnp.asarray(mib)))
    n_sc = tcfg.fp.n_sc
    h = _crandn(rng, (3, 2, n_sc))
    rx = h[:, None, :, None, :] * np.asarray(want)[:, :, None] + 0.1 * _crandn(rng, (3, 4, 2, 14, n_sc))
    got = tpbch.pbch_rx_grids(tcfg, torch.as_tensor(rx), torch.as_tensor(h))
    ref = _compiled(lambda r, hh: jpbch.pbch_rx_grids(jcfg, r, hh), jnp.asarray(rx), jnp.asarray(h))
    for g, w in zip(got, ref):
        _eq(g, w)
    assert bool(got[1].all()) and (got[2] == ports).all()
    _eq(got[0], mib)


# --------------------------------------------------------------------------
# PCFICH, PHICH, PDCCH
# --------------------------------------------------------------------------

def test_reg_maps_match_jax():
    for n_rb, cell in ((6, 0), (25, 7), (50, 17), (100, 301)):
        np.testing.assert_array_equal(tpdcch.symbol0_regs(n_rb, cell), jpdcch.symbol0_regs(n_rb, cell))
        np.testing.assert_array_equal(tpdcch.pcfich_reg_indices(n_rb, cell),
                                      jpdcch.pcfich_reg_indices(n_rb, cell))
        for g in (1, 2):
            np.testing.assert_array_equal(tpdcch.phich_reg_indices(n_rb, cell, g),
                                          jpdcch.phich_reg_indices(n_rb, cell, g))
            assert tpdcch._pdcch_avail_regs(n_rb, cell, g) == jpdcch._pdcch_avail_regs(n_rb, cell, g)
        n_cce = len(jpdcch._pdcch_avail_regs(n_rb, cell, 1)) // 9
        np.testing.assert_array_equal(tpdcch._quad_positions(9 * n_cce, cell),
                                      jpdcch._quad_positions(9 * n_cce, cell))
        for al in (1, 2, 4, 8):
            for cce0 in range(0, n_cce - al + 1, al):
                np.testing.assert_array_equal(tpdcch._cce_sc_list(n_rb, cell, cce0, al),
                                              jpdcch._cce_sc_list(n_rb, cell, cce0, al))


def test_pcfich_phich_match_jax():
    """Symbols within 1e-6; the decoded CFI and ACK equal JAX's on noisy
    2-RX inputs (the test_lte_pdcch.py cases)."""
    rng = np.random.default_rng(0)
    for cfi in (1, 2, 3):
        syms = tpdcch.pcfich_encode(cfi, 3, 7)
        want = jpdcch.pcfich_encode(cfi, subframe=3, cell_id=7)
        assert _rel(syms.numpy(), want) <= TX_TOL
        h = np.broadcast_to(_crandn(rng, (4, 2, 1)), (4, 2, 16)).copy()
        y = (h * np.asarray(want)[None, None] + 0.7 * _crandn(rng, (4, 2, 16))).astype(np.complex64)
        got = tpdcch.pcfich_decode(torch.as_tensor(y), torch.as_tensor(h), 3, 7)
        _eq(got, _compiled(lambda a, b: jpdcch.pcfich_decode(a, b, 3, 7), jnp.asarray(y),
                           jnp.asarray(h)))
    for ack in (0, 1):
        syms = tpdcch.phich_encode(ack, n_seq=2)
        want = jpdcch.phich_encode(ack, n_seq=2)
        assert _rel(syms.numpy(), want) <= TX_TOL
        h = np.broadcast_to(_crandn(rng, (4, 2, 1)), (4, 2, 12)).copy()
        y = (h * np.asarray(want)[None, None] + 1.0 * _crandn(rng, (4, 2, 12))).astype(np.complex64)
        got = tpdcch.phich_decode(torch.as_tensor(y), torch.as_tensor(h), n_seq=2)
        _eq(got, _compiled(lambda a, b: jpdcch.phich_decode(a, b, n_seq=2), jnp.asarray(y),
                           jnp.asarray(h)))


def test_dci_codec_matches_jax():
    rng = np.random.default_rng(3)
    A, rnti, E = 27, 0x5678, 144
    pay = rng.integers(0, 2, (4, A)).astype(np.int8)
    e = tpdcch.dci_encode(torch.as_tensor(pay), rnti, E)
    want = _compiled(lambda p: jpdcch.dci_encode(p, rnti, E), jnp.asarray(pay))
    _eq(e, want)
    llr = (2.0 * (1.0 - 2.0 * np.asarray(want)) + 1.2 * rng.standard_normal((4, E))).astype(np.float32)
    for r in (rnti, 0x1111):
        got = tpdcch.dci_decode(torch.as_tensor(llr), A, r)
        ref = _compiled(lambda x: jpdcch.dci_decode(x, A, r), jnp.asarray(llr))
        for g, w in zip(got, ref):
            _eq(g, w)
        assert bool(got[1].all()) == (r == rnti)


def _pdcch_symbol(n_rb, cell, sf, dcis, rng, noise):
    """Symbol-0 REs (B, 1, n_sc) carrying `dcis` [(payload, rnti, al, cce0)]
    through JAX's TX (the port's TX held within 1e-6 of it), a flat channel
    and noise."""
    y0 = 0.0
    for pay, rnti, al, cce0 in dcis:
        got = tpdcch.pdcch_tx_symbol0(n_rb, cell, sf, torch.as_tensor(pay), rnti, al, cce0)
        want = np.asarray(_compiled(lambda p: jpdcch.pdcch_tx_symbol0(n_rb, cell, sf, p, rnti,
                                                                      aggregation=al, cce0=cce0),
                                    jnp.asarray(pay)))
        assert _rel(got.numpy(), want) <= TX_TOL
        y0 = y0 + want
    B, n_sc = y0.shape
    h = np.broadcast_to(_crandn(rng, (B, 1, 1)), (B, 1, n_sc)).copy()
    return (h * y0[:, None] + noise * _crandn(rng, (B, 1, n_sc))).astype(np.complex64), h


@pytest.mark.parametrize("case", ["two-rntis", "same-rnti-cce0", "wrong-rnti"])
def test_pdcch_blind_decode_matches_jax(case):
    """Two DCIs in one control region (AL 2 and AL 4 of two RNTIs at 50 PRB;
    or two AL-2 DCIs of one RNTI told apart by cce0_list at 25 PRB, as the
    lte-softmodem loop sends them); payload, found and level equal JAX's,
    and another RNTI finds nothing."""
    rng = np.random.default_rng(5)
    A, sf = 27, 1
    if case == "same-rnti-cce0":
        n_rb, cell = 25, 17
        pays = [rng.integers(0, 2, (3, A)).astype(np.int8) for _ in range(2)]
        y0, h = _pdcch_symbol(n_rb, cell, sf, [(pays[0], 0x4444, 2, 0), (pays[1], 0x4444, 2, 2)],
                              rng, 0.1)
        searches = [(0x4444, dict(aggregations=(2,), cce0_list=(0,)), pays[0]),
                    (0x4444, dict(aggregations=(2,), cce0_list=(2,)), pays[1])]
    else:
        n_rb, cell = 50, 7
        pays = [rng.integers(0, 2, (3, A)).astype(np.int8) for _ in range(2)]
        y0, h = _pdcch_symbol(n_rb, cell, sf, [(pays[0], 0x5678, 2, 0), (pays[1], 0x1234, 4, 4)],
                              rng, 0.1)
        if case == "two-rntis":
            searches = [(0x5678, {}, pays[0]), (0x1234, {}, pays[1])]
        else:
            searches = [(0x0BAD, {}, None)]
    for rnti, kw, sent in searches:
        got = tpdcch.pdcch_blind_decode(torch.as_tensor(y0), torch.as_tensor(h), n_rb, cell, sf,
                                        rnti, A, **kw)
        ref = _compiled(lambda y, hh: jpdcch.pdcch_blind_decode(y, hh, n_rb, cell, sf, rnti, A,
                                                                **kw),
                        jnp.asarray(y0), jnp.asarray(h))
        for g, w in zip(got, ref):
            _eq(g, w)
        if sent is None:
            assert not bool(got[1].any())
        else:
            assert bool(got[1].all())
            _eq(got[0], sent)


# --------------------------------------------------------------------------
# PUCCH
# --------------------------------------------------------------------------

def _fade(rng, grid, n_rx, noise):
    B, n_sc = grid.shape[0], grid.shape[-1]
    h = _crandn(rng, (B, n_rx, 1, 1)) / np.sqrt(2)
    return (h * grid[:, None] + noise * _crandn(rng, (B, n_rx, 14, n_sc))).astype(np.complex64)


@pytest.mark.parametrize("fmt", ["1", "1a", "1b"])
def test_pucch1_matches_jax(fmt):
    """TX grid within 1e-6; d_hat within 1e-5, bits and detected equal, on
    signals and on noise alone (DTX)."""
    kw = dict(n_rb=25, cell_id=17, prb=3, n_oc=2, cs0=5, n_rx=2)
    tcfg, jcfg = tpucch.LtePucch1Config(**kw), jpucch.LtePucch1Config(**kw)
    rng = np.random.default_rng(len(fmt))
    n_bits = {"1": 0, "1a": 1, "1b": 2}[fmt]
    bits = None if n_bits == 0 else rng.integers(0, 2, (4, n_bits)).astype(np.int8)
    got = tpucch.pucch1_tx(tcfg, None if bits is None else torch.as_tensor(bits))
    want = np.asarray(jpucch.pucch1_tx(jcfg, None if bits is None else jnp.asarray(bits)))
    assert _rel(got.numpy(), want) <= TX_TOL
    for rx in (_fade(rng, want, 2, 0.2), (0.2 * _crandn(rng, (4, 2, 14, 300)))):
        out = tpucch.pucch1_rx(tcfg, torch.as_tensor(rx), n_bits=n_bits)
        ref = _compiled(lambda r: jpucch.pucch1_rx(jcfg, r, n_bits=n_bits), jnp.asarray(rx))
        assert _rel(out["d_hat"].numpy(), ref["d_hat"]) <= EST_TOL
        _eq(out["detected"], ref["detected"])
        if n_bits:
            _eq(out["bits"], ref["bits"])
    if bits is not None:
        _eq(tpucch.pucch1_rx(tcfg, torch.as_tensor(_fade(rng, want, 2, 0.1)), n_bits)["bits"], bits)


def test_pucch1_user_separation_matches_jax():
    """Three users on one PRB by orthogonal cover and cyclic shift, each
    decoded as JAX decodes it."""
    cfgs = [dict(n_rb=25, cell_id=7, prb=1, n_oc=oc, cs0=cs, n_rx=1)
            for oc, cs in ((0, 0), (1, 2), (2, 4))]
    rng = np.random.default_rng(2)
    bits = [rng.integers(0, 2, (4, 1)).astype(np.int8) for _ in cfgs]
    grid = sum(np.asarray(jpucch.pucch1_tx(jpucch.LtePucch1Config(**kw), jnp.asarray(b)))
               for kw, b in zip(cfgs, bits))
    rx = _fade(rng, grid, 1, 0.1)
    for kw, b in zip(cfgs, bits):
        out = tpucch.pucch1_rx(tpucch.LtePucch1Config(**kw), torch.as_tensor(rx))
        ref = _compiled(lambda r: jpucch.pucch1_rx(jpucch.LtePucch1Config(**kw), r), jnp.asarray(rx))
        assert _rel(out["d_hat"].numpy(), ref["d_hat"]) <= EST_TOL
        _eq(out["bits"], ref["bits"])
        _eq(out["bits"], b)


def test_rm20_matches_jax():
    """rm20_encode and rm20_decode for every A up to 13, on noisy codewords."""
    rng = np.random.default_rng(4)
    for A in range(1, 14):
        bits = rng.integers(0, 2, (6, A)).astype(np.int8)
        cw = tpucch.rm20_encode(torch.as_tensor(bits))
        _eq(cw, _compiled(jpucch.rm20_encode, jnp.asarray(bits)))
        llr = (1.0 - 2.0 * cw.numpy() + 0.8 * rng.standard_normal((6, 20))).astype(np.float32)
        got = tpucch.rm20_decode(torch.as_tensor(llr), A)
        _eq(got, _compiled(lambda x: jpucch.rm20_decode(x, A), jnp.asarray(llr)))
    # a tie between codewords: all-zero LLRs give codeword 0
    _eq(tpucch.rm20_decode(torch.zeros((1, 20)), 7), jpucch.rm20_decode(jnp.zeros((1, 20)), 7))


@pytest.mark.parametrize("n_bits", [4, 13])
def test_pucch2_matches_jax(n_bits):
    kw = dict(n_rb=25, cell_id=17, prb=1, cs0=3, rnti=0x4321, n_bits=n_bits)
    tcfg, jcfg = tpucch.LtePucch2Config(**kw), jpucch.LtePucch2Config(**kw)
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (4, n_bits)).astype(np.int8)
    got = tpucch.pucch2_tx(tcfg, torch.as_tensor(bits))
    want = np.asarray(_compiled(lambda b: jpucch.pucch2_tx(jcfg, b), jnp.asarray(bits)))
    assert _rel(got.numpy(), want) <= TX_TOL
    noise = 0.15 * _crandn(rng, (4, 1, 14, 300))
    for rx in (want[:, None] + noise, noise):
        out = tpucch.pucch2_rx(tcfg, torch.as_tensor(rx))
        ref = _compiled(lambda r: jpucch.pucch2_rx(jcfg, r), jnp.asarray(rx))
        assert _rel(out["llrs"].numpy(), ref["llrs"]) <= LLR_TOL
        _eq(out["uci"], ref["uci"])
        _eq(out["detected"], ref["detected"])
    _eq(tpucch.pucch2_rx(tcfg, torch.as_tensor(want[:, None] + noise))["uci"], bits)


# --------------------------------------------------------------------------
# SRS, PRACH
# --------------------------------------------------------------------------

def test_srs_matches_jax():
    kw = dict(n_rb=25, srs_rb=24, cell_id=7, cyclic_shift=3, n_rx=2)
    tcfg, jcfg = tsrs.LteSrsConfig(**kw), jsrs.LteSrsConfig(**kw)
    np.testing.assert_array_equal(tcfg.sequence_np(), jcfg.sequence_np())
    np.testing.assert_array_equal(tcfg.sc_indices(), jcfg.sc_indices())
    tx = tsrs.srs_tx(tcfg, batch=2)
    want = np.asarray(jsrs.srs_tx(jcfg, batch=2))
    assert _rel(tx.numpy(), want) <= TX_TOL
    rng = np.random.default_rng(0)
    y = (_crandn(rng, (2, 2, 1)) * want[:, None] + 0.05 * _crandn(rng, (2, 2, 300))).astype(np.complex64)
    out = tsrs.srs_rx(tcfg, torch.as_tensor(y))
    ref = _compiled(lambda x: jsrs.srs_rx(jcfg, x), jnp.asarray(y))
    for k in ("h", "snr_db", "noise_var"):
        assert _rel(out[k].numpy(), ref[k]) <= EST_TOL, k
    assert float(out["snr_db"].min()) > 15.0


@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_prach_matches_jax(fmt):
    """Each format's config (Ncs 13-22); TX within 1e-6; detection
    (preamble, delay, detected equal, metric within 1e-5) on preambles of
    both roots; the preambles sent are found, but at Ncs 15 (format 1
    here), where both packages find preamble 84 for 83: its peak falls 0.6
    of a bin before its window, whose start models/prach.py floors (ROADMAP
    Queue 3)."""
    kw = dict(format=fmt, root_sequence_index=22 + fmt, zero_correlation_zone=1 + fmt)
    tcfg, jcfg = tprach.LtePrachConfig(**kw), jprach.LtePrachConfig(**kw)
    assert (tcfg.roots, tcfg.n_cs, tcfg.n_preambles, tcfg.durations_ts()) == \
           (jcfg.roots, jcfg.n_cs, jcfg.n_preambles, jcfg.durations_ts())
    rng = np.random.default_rng(fmt)
    idx = rng.integers(0, tcfg.n_preambles, 3)
    tx = tprach.prach_tx(tcfg, torch.as_tensor(idx))
    want = np.asarray(jprach.prach_tx(jcfg, jnp.asarray(idx)))
    assert _rel(tx.numpy(), want) <= TX_TOL
    rx = (want[:, None] + 0.3 * _crandn(rng, (3, 2, 839))).astype(np.complex64)
    out = tprach.prach_rx(tcfg, torch.as_tensor(rx))
    ref = _compiled(lambda r: jprach.prach_rx(jcfg, r), jnp.asarray(rx))
    for k in ("detected", "preamble", "delay"):
        _eq(out[k], ref[k])
    assert _rel(out["metric"].numpy(), ref["metric"]) <= EST_TOL
    if fmt != 1:
        _eq(out["preamble"], idx)


def test_prach_dtx_matches_jax():
    cfg = tprach.LtePrachConfig()
    rx = (0.3 * _crandn(np.random.default_rng(1), (2, 2, 839))).astype(np.complex64)
    out = tprach.prach_rx(cfg, torch.as_tensor(rx))
    ref = _compiled(lambda x: jprach.prach_rx(jprach.LtePrachConfig(), x), jnp.asarray(rx))
    _eq(out["detected"], ref["detected"])
    assert not bool(out["detected"].any())
    assert _rel(out["metric"].numpy(), ref["metric"]) <= EST_TOL
