"""The port's lower-split fronthaul codecs against the JAX package's, on the
CPU: IF5 (time-domain int16 block floating point, fronthaul/if5.py) and the
O-RAN 7.2 U-plane (eCPRI, 9-bit BFP per PRB, fronthaul/oran.py); cases after
tests/test_ru_l1_split.py::test_if5_time_domain_roundtrip and
test_oran_ecpri_uplane_roundtrip.

Packets are byte-equal to JAX's on seeded waveforms and grids at 24 PRB
and on the codecs' edge cases: an all-zero chunk or PRB, the short last
chunk (7680 = 3 x 2048 + 1536 samples), a max that is a power of two,
magnitudes past 2**15 (the exponent's cap), values at or next to a
rounding half.  The reassembled waveform and grid are bit-equal to JAX's,
and the 24-PRB slot decodes through the port's plain receiver.
"""
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.fronthaul import if5 as jif5
from openairinterface5g_tpu.fronthaul import oran as joran
from openairinterface5g_tpu_torch.fronthaul import if5, oran
from openairinterface5g_tpu_torch.models.pusch import PuschConfig, pusch_rx, pusch_rx_grid, pusch_tx
from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

CPU = "cpu"
N_SAMP_24 = 7680            # one 24-PRB slot at mu = 1 (FFT 512)


def _crandn(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
            ).astype(np.complex64)


def _bits(a: np.ndarray) -> np.ndarray:
    """The float32 bit patterns of a complex64 array."""
    return np.ascontiguousarray(a, np.complex64).view(np.int32)


def _if5_waveform(rng):
    """(2, 7680) with the edge cases: antenna 1's second chunk all zero, a
    chunk whose max is exactly 1.0 beside values at k + 0.5 steps of 1/32767,
    and one of magnitude 1e5."""
    x = _crandn(rng, (2, N_SAMP_24), 0.3)
    x[1, 2048:4096] = 0
    half = (np.arange(-40, 40) + 0.5).astype(np.float32) / np.float32(32767)
    x[0, 2048:4096] = 0
    x[0, 2048: 2048 + 80] = half + 1j * half[::-1]
    x[0, 2200] = 1.0 + 0.5j          # the chunk's max: 1.0, and an exact half (16383.5)
    x[1, 4096:4100] = 1e5 * np.array([1, -1, 1j, -1j], np.complex64)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_if5_packets_equal_jax(seed):
    rng = np.random.default_rng(seed)
    x = _if5_waveform(rng)
    pj = jif5.slot_to_packets(jif5.UL_TD, 7, 3, x, seq0=11)
    pt = if5.slot_to_packets(if5.UL_TD, 7, 3, torch.from_numpy(x), seq0=11)
    assert len(pt) == 8 and [len(p) for p in pt] == [len(p) for p in pj]
    assert pt == pj
    assert if5.pack_chunk(if5.DL_TD, 9, 2, 1, 0, 5, torch.from_numpy(x[0, :1536])) == \
        jif5.pack_chunk(jif5.DL_TD, 9, 2, 1, 0, 5, x[0, :1536])
    assert (if5.MAGIC, if5.UL_TD, if5.DL_TD, if5.CHUNK) == \
        (jif5.MAGIC, jif5.UL_TD, jif5.DL_TD, jif5.CHUNK)


def test_if5_reassembly_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    x = _if5_waveform(rng)
    pkts = jif5.slot_to_packets(jif5.UL_TD, 7, 3, x)
    rng.shuffle(pkts)                               # UDP reordering
    jt, jf, js, jw = jif5.packets_to_slot(pkts, 2, N_SAMP_24)
    tt, tf, ts, tw = if5.packets_to_slot(pkts, 2, N_SAMP_24, device=CPU)
    assert (tt, tf, ts) == (jt, jf, js) == (if5.UL_TD, 7, 3)
    assert tw.dtype == torch.complex64 and tw.device.type == "cpu"
    np.testing.assert_array_equal(_bits(tw.numpy()), _bits(jw))
    for p in pkts[:3]:
        j, t = jif5.unpack_chunk(p), if5.unpack_chunk(p, device=CPU)
        assert t[:5] == j[:5]
        np.testing.assert_array_equal(_bits(t[5].numpy()), _bits(j[5]))
    # a lost datagram leaves its chunk zero, as in JAX
    jw2 = jif5.packets_to_slot(pkts[1:], 2, N_SAMP_24)[3]
    tw2 = if5.packets_to_slot(pkts[1:], 2, N_SAMP_24, device=CPU)[3]
    np.testing.assert_array_equal(_bits(tw2.numpy()), _bits(jw2))


def _oran_grid(rng, n_sym=14, n_prb=24):
    """(n_sym, 12 n_prb) with the edge cases: a zero PRB, PRBs whose max is
    1.0 and 2.0 exactly, one past 2**15, values next to a mantissa half."""
    g = _crandn(rng, (n_sym, 12 * n_prb), 2.3)
    g[3, :12] = 0
    g[4, :12] = 0.5
    g[4, 1] = 2.0
    g[4, 12:24] = 0.25
    g[4, 13] = -1.0
    g[5, :12] = 1e5 * (1 + 1j)
    g[5, 12:24] = 40000.0 - 3j
    near = ((np.arange(12) + 0.5) / 255).astype(np.float32)
    g[6, :12] = near + 1j * near[::-1]
    g[6, 24:36] = np.nextafter(near, np.float32(1)) - 1j * np.nextafter(near, np.float32(0))
    return g


def test_oran_prb_codec_equals_jax():
    rng = np.random.default_rng(3)
    g = _oran_grid(rng)
    prbs = g.reshape(-1, 12)
    got = oran._bfp_compress(torch.from_numpy(prbs)).numpy()
    for p in range(prbs.shape[0]):
        want = joran._bfp_compress_prb(prbs[p])
        assert got[p].tobytes() == want == oran._bfp_compress_prb(torch.from_numpy(prbs[p])), p
        np.testing.assert_array_equal(_bits(oran._bfp_decompress_prb(want).numpy()),
                                      _bits(joran._bfp_decompress_prb(want)))
    exps = got[:, 0] >> 4
    assert set(exps[[4 * 24, 4 * 24 + 1, 5 * 24, 5 * 24 + 1, 3 * 24]]) == {1, 0, 15}


@pytest.mark.parametrize("max_prb", [64, 7])
def test_oran_packets_equal_jax(max_prb):
    rng = np.random.default_rng(4)
    g = np.stack([_oran_grid(rng), _oran_grid(rng)])         # (2 antennas, 14, 288)
    want = []
    for a in range(2):
        seq = 5
        for s in range(14):
            pk = joran.symbol_to_uplane(a, seq, 9, 4, 13, s, g[a, s], max_prb_per_pkt=max_prb)
            assert oran.symbol_to_uplane(a, seq, 9, 4, 13, s, torch.from_numpy(g[a, s]),
                                         max_prb_per_pkt=max_prb) == pk
            want += pk
            seq += len(pk)
    got = oran.grid_to_uplane(torch.from_numpy(g), frame=9, subframe=4, slot=13, seq0=5,
                              max_prb_per_pkt=max_prb)
    assert len(got) == 2 * 14 * -(-24 // max_prb)
    assert got == want
    m = joran.OranUPlane(pcid=3, seqid=77, frame=21, subframe=4, slot=13, start_sym=9,
                         iq=g[0, 2, :48].reshape(4, 12))
    tm = oran.OranUPlane(pcid=3, seqid=77, frame=21, subframe=4, slot=13, start_sym=9,
                         iq=torch.from_numpy(g[0, 2, :48].reshape(4, 12)))
    assert oran.pack_uplane(tm) == joran.pack_uplane(m)
    u, ju = oran.unpack_uplane(joran.pack_uplane(m), device=CPU), joran.unpack_uplane(
        joran.pack_uplane(m))
    assert (u.pcid, u.seqid, u.frame, u.subframe, u.slot, u.start_sym) == \
        (ju.pcid, ju.seqid, ju.frame, ju.subframe, ju.slot, ju.start_sym) == (3, 77, 21, 4, 13, 9)
    np.testing.assert_array_equal(_bits(u.iq.numpy()), _bits(ju.iq))
    assert (oran.IQ_WIDTH, oran.ECPRI_IQ, oran.ECPRI_RTC) == \
        (joran.IQ_WIDTH, joran.ECPRI_IQ, joran.ECPRI_RTC)


def test_oran_grid_rebuilt_bit_equal_to_jax():
    """uplane_to_grid from shuffled packets (7 PRBs a packet: 4 per symbol)
    against JAX's unpack_uplane placed packet by packet."""
    rng = np.random.default_rng(5)
    g = np.stack([_oran_grid(rng), _oran_grid(rng)])
    pkts = oran.grid_to_uplane(torch.from_numpy(g), max_prb_per_pkt=7, seq0=0xFFFE)
    want = np.zeros_like(g)
    offs = {}
    for p in pkts:                                      # in order: the PRB offsets
        u = joran.unpack_uplane(p)
        k = offs.get((u.pcid, u.start_sym), 0)
        want[u.pcid, u.start_sym, 12 * k: 12 * (k + u.iq.shape[0])] = u.iq.reshape(-1)
        offs[(u.pcid, u.start_sym)] = k + u.iq.shape[0]
    order = rng.permutation(len(pkts))
    got = oran.uplane_to_grid([pkts[i] for i in order], 2, 14, 288, device=CPU)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _slot(seed):
    """tests/test_ru_l1_split.py's slot: 24 PRB, MCS 9, 1 layer, 1 RX, the
    port's TX plus 0.02 complex noise; the port's plain receiver."""
    cfg = PuschConfig(mu=1, n_prb=24, mcs=9, n_layers=1, n_rx=1, decoder_backend="reference")
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, (1, cfg.tbs)).astype(np.int8)
    tx = pusch_tx(cfg, torch.as_tensor(tb))[0]
    rx = tx + 0.02 * torch.as_tensor(_crandn(rng, tuple(tx.shape)))
    return cfg, tb, rx


def test_if5_slot_decodes():
    cfg, tb, rx = _slot(0)
    x = rx[0]                                            # (1, 7680)
    pkts = if5.slot_to_packets(if5.UL_TD, 7, 3, x)
    assert pkts == jif5.slot_to_packets(jif5.UL_TD, 7, 3, x.numpy())
    np.random.default_rng(1).shuffle(pkts)
    typ, frame, slot, wav = if5.packets_to_slot(pkts, 1, x.shape[-1], device=CPU)
    assert (typ, frame, slot) == (if5.UL_TD, 7, 3)
    np.testing.assert_array_equal(_bits(wav.numpy()),
                                  _bits(jif5.packets_to_slot(pkts, 1, x.shape[-1])[3]))
    assert float((wav - x).abs().max() / x.abs().max()) < 2e-3
    out = pusch_rx(cfg, wav[None], n_iters=8)
    assert bool(out["tb_ok"][0]) and np.array_equal(out["tb_bits"].numpy(), tb)


def test_oran_slot_decodes():
    cfg, tb, rx = _slot(2)
    grid = extract_from_grid(cfg.fp, ofdm_demodulate(cfg.fp, rx, 0))[0]     # (1, 14, 288)
    pkts = oran.grid_to_uplane(grid)
    rebuilt = oran.uplane_to_grid(pkts, 1, 14, grid.shape[-1], device=CPU)
    assert float((rebuilt - grid).abs().max() / grid.abs().max()) < 5e-3
    out = pusch_rx_grid(cfg, rebuilt[None], n_iters=8)
    assert bool(out["tb_ok"][0]) and np.array_equal(out["tb_bits"].numpy(), tb)
