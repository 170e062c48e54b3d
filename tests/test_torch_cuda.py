"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

Needs an NVIDIA GPU with nvcc (the kernels build for sm_90a); skipped
elsewhere.  Imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch

from openairinterface5g_tpu_torch.coding import ldpc
from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import ldpc_decoder
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
from openairinterface5g_tpu_torch.ops.pusch_frontend_cases import CARD_CASES

pytestmark = pytest.mark.cuda

# the six frontend configurations of tests/test_pusch_frontend_pallas.py
FRONTEND_CFGS = [
    dict(n_prb=24, mcs=9, n_layers=1, n_rx=1),
    dict(n_prb=51, mcs=16, n_layers=1, n_rx=2, chest_window=8),
    dict(n_prb=24, mcs=16, n_layers=2, n_rx=2),
    dict(n_prb=24, mcs=19, n_layers=2, n_rx=2, dmrs_symbols=(2, 11)),
    dict(n_prb=24, mcs=9, n_layers=2, n_rx=2, dmrs_port0=2),
    dict(n_prb=16, mcs=26, n_layers=1, n_rx=2, chest_window=0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rx_grid(cfg, dev, seed, B=3, noise=0.1):
    rng = np.random.default_rng(seed)
    tb = torch.as_tensor(rng.integers(0, 2, (B, cfg.tbs)).astype(np.int8), device=dev)
    grid_re, _ = pusch.pusch_tx_grid(cfg, tb)
    h = (rng.standard_normal((cfg.n_rx, cfg.n_layers))
         + 1j * rng.standard_normal((cfg.n_rx, cfg.n_layers))) / np.sqrt(2)
    y = torch.einsum("rl,blsm->brsm", torch.as_tensor(h.astype(np.complex64), device=dev), grid_re)
    n = rng.standard_normal((2, *y.shape)).astype(np.float32)
    return (y + noise * torch.complex(torch.as_tensor(n[0], device=dev),
                                      torch.as_tensor(n[1], device=dev))).contiguous()


@pytest.mark.parametrize("kw", FRONTEND_CFGS)
def test_frontend_kernel_matches_plain(cuda, kw):
    cfg = pusch.PuschConfig(mu=1, **kw)
    y = _rx_grid(cfg, cuda, seed=len(str(kw)))
    ref = fe.frontend_planes_plain(cfg, y)
    n0 = fe.launches
    got = fe.frontend_planes(cfg, y)
    torch.cuda.synchronize()
    assert fe.launches == n0 + 1
    assert got.shape == ref.shape == (3, cfg.qm_rate[0], cfg.G // cfg.qm_rate[0])
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 2e-4, err


def _frontend_err(kw, dev, seed, B):
    """K3's relative error against its plain version on one configuration,
    the kernel launched once."""
    cfg = pusch.PuschConfig(mu=1, **kw)
    y = _rx_grid(cfg, dev, seed, B=B)
    ref = fe.frontend_planes_plain(cfg, y)
    n0 = fe.launches
    got = fe.frontend_planes(cfg, y)
    torch.cuda.synchronize()
    assert fe.launches == n0 + 1
    assert got.shape == ref.shape == (B, cfg.qm_rate[0], cfg.G // cfg.qm_rate[0])
    assert bool(torch.isfinite(got).all())
    return float((got - ref).abs().max() / ref.abs().max())


# K3's tile edges, B = 1 and B = 40, many antennas (ops/pusch_frontend_cases.py)
@pytest.mark.parametrize("kw,B", CARD_CASES)
def test_frontend_kernel_edges(cuda, kw, B):
    err = _frontend_err(kw, cuda, seed=len(str(kw)) + B, B=B)
    assert err < 2e-4, err


@pytest.mark.parametrize("kw", [dict(n_prb=20, mcs=16, n_layers=2, n_rx=2),
                                dict(n_prb=273, mcs=16, n_layers=2, n_rx=2),
                                dict(n_prb=51, mcs=9, n_layers=1, n_rx=3, chest_window=16),
                                dict(n_prb=3, mcs=16, n_layers=2, n_rx=2, chest_window=16),
                                dict(n_prb=1, mcs=16, n_layers=2, n_rx=2)])
def test_frontend_kernel_at_every_cluster_size(cuda, kw):
    """Every cluster size the kernel takes, where its shape fits: the plan's
    first and its fallbacks, and tiles that hold fewer pilots than the
    halo."""
    cfg = pusch.PuschConfig(mu=1, **kw)
    y = _rx_grid(cfg, cuda, seed=11)
    ref = fe.frontend_planes_plain(cfg, y)
    sizes = [c for c in fe.cluster_sizes(cfg.n_prb)
             if fe.shape_of(c, cfg.n_rx, cfg.n_layers, 6 * cfg.n_prb, len(cfg.dmrs_symbols),
                            len(cfg.data_symbols), cfg.chest_window)]
    assert sizes[0] == fe.cluster_sizes(cfg.n_prb)[0] >= fe.planned_cluster(cfg.n_prb)
    for c in sizes:
        got = fe._launch(cfg, y, C=c)
        assert float((got - ref).abs().max() / ref.abs().max()) < 2e-4, c


def test_frontend_launch_refuses_a_short_shape(cuda):
    """The C side checks the caps and the shared memory it is given against
    what the tiles and the layout need, and launches nothing when short."""
    from openairinterface5g_tpu_torch.ops import _cuda
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2)
    y = _rx_grid(cfg, cuda, seed=12)
    plan = fe._plan(cfg, y.device)
    planes = torch.empty((3, *plan.planes_shape), device=cuda)
    r = _cuda.route()
    for field, cut in (("tile_cap", 4), ("ls_cap", 2), ("hs_cap", 2), ("smem", 16)):
        shape = plan.shape._replace(**{field: getattr(plan.shape, field) - cut})
        rc = r.pusch_frontend(y.data_ptr(), *plan.ptrs, planes.data_ptr(), 3,
                              *plan.ints[:-len(shape)], *shape, y.get_device(),
                              r.stream(y.get_device()))
        assert rc != 0, field


def test_frontend_kernel_in_a_cuda_graph(cuda):
    """K3's cluster launch captured in a CUDA graph and replayed on a new
    grid gives that grid's planes."""
    cfg = pusch.PuschConfig(mu=1, n_prb=51, mcs=16, n_layers=2, n_rx=2)
    y = _rx_grid(cfg, cuda, seed=21)
    fe.frontend_planes(cfg, y)                  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fe.frontend_planes(cfg, y)
    y.copy_(_rx_grid(cfg, cuda, seed=22))
    graph.replay()
    torch.cuda.synchronize()
    ref = fe.frontend_planes_plain(cfg, y)
    assert float((out - ref).abs().max() / ref.abs().max()) < 2e-4


def test_frontend_kernel_bwp_offset(cuda):
    """Allocation inside a wider BWP (sc0 > 0)."""
    cfg = pusch.PuschConfig(mu=1, n_prb=24, n_bwp_prb=40, prb_start=7, mcs=16,
                            n_layers=2, n_rx=2)
    y = _rx_grid(cfg, cuda, seed=5)
    ref = fe.frontend_planes_plain(cfg, y)
    got = fe.frontend_planes(cfg, y)
    assert float((got - ref).abs().max() / ref.abs().max()) < 2e-4


def test_frontend_kernel_rejects_bad_input(cuda):
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2)
    y = _rx_grid(cfg, cuda, seed=1)
    with pytest.raises(ValueError):
        fe.frontend_planes(cfg, y[:, :1].contiguous())
    with pytest.raises(ValueError):
        fe.frontend_planes(cfg, y.transpose(2, 3).contiguous().transpose(2, 3))


def _awgn_llr(g, n_cb, seed, snr_db, case="awgn"):
    """(info, f32 LLRs) of random code blocks, BPSK over AWGN, punctured
    head at 0.  snr_db: one Es/N0 or a (low, high) ramp across the batch,
    so that blocks stop at different iterations.  case "ties": quantized to
    a few values; "zeros": every second block all zero and -0.0 in some
    others; "all zero": every LLR +0.0."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (n_cb, g.K)).astype(np.int8)
    cw = ldpc.encode(g, torch.as_tensor(info)).numpy().astype(np.float32)
    db = np.linspace(*snr_db, n_cb)[:, None] if isinstance(snr_db, tuple) else snr_db
    sigma = np.float32(10 ** (-np.asarray(db) / 20))
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr = (2 * y / sigma ** 2).astype(np.float32)
    llr[:, : 2 * g.Z] = 0
    if case == "ties":
        llr = np.rint(llr / 4) * 4
    elif case == "zeros":
        llr[1::2] = 0.0
        llr[::3, 5::7] = -0.0
    elif case == "all zero":
        llr = np.zeros_like(llr)
    return info, llr


@pytest.mark.parametrize("bg,Z,n_cb", [(2, 64, 5), (2, 104, 7), (1, 384, 9), (1, 13, 4)])
@pytest.mark.parametrize("dtype,check_every", [(torch.float32, 0), (torch.bfloat16, 1),
                                               (torch.float32, 2)])
def test_decoder_kernel_matches_plain(cuda, bg, Z, n_cb, dtype, check_every):
    g = ldpc.build_graph(bg, Z)
    info, llr = _awgn_llr(g, n_cb, seed=Z + bg, snr_db=1.0)
    x = torch.as_tensor(llr, device=cuda).to(dtype)
    n0 = ldpc_decoder.launches["layered_f32"]
    bk, okk = ldpc_decoder.decode(g, x, 6, check_every=check_every)
    bp, okp = ldpc_decoder.decode_plain(g, x, 6, check_every=check_every)
    torch.cuda.synchronize()
    assert ldpc_decoder.launches["layered_f32"] == n0 + 1
    assert bk.dtype == torch.int8 and okk.dtype == torch.bool
    assert torch.equal(bk, bp)
    assert torch.equal(okk, okp)
    # and where both report parity, the decode is the sent word
    for i in np.nonzero(okk.cpu().numpy())[0]:
        np.testing.assert_array_equal(bk[i].cpu().numpy(), info[i])


def test_decoder_kernel_rejects_bad_input(cuda):
    g = ldpc.build_graph(2, 64)
    with pytest.raises(ValueError):
        ldpc_decoder.decode(g, torch.zeros((2, 10), device=cuda))
    with pytest.raises(ValueError):   # not contiguous
        ldpc_decoder.decode(g, torch.zeros((g.cols * g.Z, 2), device=cuda).t())
    with pytest.raises(ValueError):
        ldpc_decoder.decode(g, torch.zeros((2, g.cols * g.Z), device=cuda), schedule="zigzag")


def test_main_path_through_both_kernels(cuda):
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2,
                            decoder_backend="kernel", decoder_check_every=1)
    rng = np.random.default_rng(3)
    tb = torch.as_tensor(rng.integers(0, 2, (4, cfg.tbs)).astype(np.int8), device=cuda)
    tx, _ = pusch.pusch_tx(cfg, tb)
    n = rng.standard_normal((2, *tx.shape)).astype(np.float32)
    rx = tx + 0.1 * tx.flip(1) + 0.05 * torch.complex(torch.as_tensor(n[0], device=cuda),
                                                      torch.as_tensor(n[1], device=cuda))
    f0, d0 = fe.launches, ldpc_decoder.launches["layered_f32"]
    out = pusch.pusch_rx(cfg, rx, n_iters=8)
    assert fe.launches == f0 + 1 and ldpc_decoder.launches["layered_f32"] == d0 + 1
    assert bool(out["tb_ok"].all())
    assert torch.equal(out["tb_bits"], tb)


# every variant decode() takes: (schedule, message type, input type); bf16
# + layered is K2
VARIANTS = [("layered", torch.float32, torch.float32), ("layered", torch.float32, torch.bfloat16),
            ("flooding", torch.float32, torch.float32), ("flooding", torch.float32, torch.bfloat16),
            ("layered", torch.int8, torch.float32), ("flooding", torch.int8, torch.float32),
            ("flooding", torch.bfloat16, torch.float32), ("layered", torch.bfloat16, torch.float32)]


# (1, 384, 208): the main path's width, one batch's code blocks
@pytest.mark.parametrize("bg,Z,n_cb", [(2, 64, 5), (1, 384, 9), (1, 13, 4), (1, 384, 208)])
@pytest.mark.parametrize("schedule,msg_dtype,in_dtype", VARIANTS)
@pytest.mark.parametrize("check_every", [0, 2])
def test_decoder_variant_kernel_matches_plain(cuda, bg, Z, n_cb, schedule, msg_dtype,
                                              in_dtype, check_every):
    g = ldpc.build_graph(bg, Z)
    info, llr = _awgn_llr(g, n_cb, seed=Z + bg, snr_db=1.0)
    x = torch.as_tensor(llr, device=cuda).to(in_dtype)
    name = ldpc_decoder.kernel_name(schedule, msg_dtype)
    n0 = ldpc_decoder.launches[name]
    kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=check_every)
    bk, okk, ik = ldpc_decoder.decode(g, x, 6, return_iters=True, **kw)
    bp, okp, ip = ldpc_decoder.decode_plain(g, x, 6, return_iters=True, **kw)
    torch.cuda.synchronize()
    assert ldpc_decoder.launches[name] == n0 + 1
    assert bk.dtype == torch.int8 and okk.dtype == torch.bool and ik.dtype == torch.int32
    assert torch.equal(bk, bp)
    assert torch.equal(okk, okp)
    assert torch.equal(ik, ip)                   # each code block's early stop
    for i in np.nonzero(okk.cpu().numpy())[0]:
        np.testing.assert_array_equal(bk[i].cpu().numpy(), info[i])


# K1's layered kernel (csrc/ldpc_layered.cu): (message type, input type)
LAYERED = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.int8, torch.float32)]


@pytest.mark.parametrize("case", ["awgn", "ties", "zeros", "all zero"])
@pytest.mark.parametrize("msg_dtype,in_dtype", LAYERED)
@pytest.mark.parametrize("n_iters,check_every", [(1, 0), (1, 1), (6, 0), (8, 1), (8, 2), (8, 3)])
def test_layered_kernel_matches_plain(cuda, case, msg_dtype, in_dtype, n_iters, check_every):
    """Bits and ok flags equal decode_plain's, for every input type, early
    stop and first-iteration case, with ties in |v|, -0.0 and zeros."""
    g = ldpc.build_graph(2, 104)
    _, llr = _awgn_llr(g, 16, seed=7, snr_db=(0.0, 4.0), case=case)
    x = torch.as_tensor(llr, device=cuda).to(in_dtype)
    name = ldpc_decoder.kernel_name("layered", msg_dtype)
    n0 = ldpc_decoder.launches[name]
    kw = dict(msg_dtype=msg_dtype, check_every=check_every)
    bk, okk = ldpc_decoder.decode(g, x, n_iters, **kw)
    bp, okp, iters = ldpc_decoder.decode_plain(g, x, n_iters, return_iters=True, **kw)
    torch.cuda.synchronize()
    assert ldpc_decoder.launches[name] == n0 + 1
    assert torch.equal(bk, bp) and torch.equal(okk, okp)
    if case == "awgn" and check_every == 1 and n_iters == 8:
        assert len(set(iters.tolist())) > 1          # blocks stop at different iterations


@pytest.mark.parametrize("check_every", [0, 1])
def test_int8_kernel_saturates(cuda, check_every):
    """Large LLRs: int8 messages saturate at +-127 in kernel and plain alike,
    under both schedules, in BG2 and in BG1 (columns of degree 30)."""
    for bg, Z in ((2, 64), (1, 104)):
        g = ldpc.build_graph(bg, Z)
        info, llr = _awgn_llr(g, 3, seed=9, snr_db=12.0)
        x = torch.as_tensor(llr * 50, device=cuda)
        for schedule in ("layered", "flooding"):
            kw = dict(schedule=schedule, msg_dtype=torch.int8, check_every=check_every,
                      return_iters=True)
            got = ldpc_decoder.decode(g, x, 5, **kw)
            want = ldpc_decoder.decode_plain(g, x, 5, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (bg, schedule)
            assert bool(got[1].all())


# K1's flooding kernel (csrc/ldpc_flooding.cu) and K2 (csrc/ldpc_layered.cu
# with K2's arithmetic): (schedule, message type, input type)
REDESIGNED = [("flooding", torch.float32, torch.float32),
              ("flooding", torch.float32, torch.bfloat16),
              ("flooding", torch.int8, torch.float32),
              ("flooding", torch.bfloat16, torch.float32),
              ("layered", torch.bfloat16, torch.float32)]


# BG2 Z=104: Z % 32 != 0, so the walk over each row's edges checks parity,
# and BG2's layers of 3 rows; BG2 Z=64: the packed check
@pytest.mark.parametrize("bg,Z", [(2, 104), (2, 64)])
@pytest.mark.parametrize("case", ["awgn", "ties", "zeros", "all zero"])
@pytest.mark.parametrize("schedule,msg_dtype,in_dtype", REDESIGNED)
@pytest.mark.parametrize("n_iters,check_every", [(1, 0), (1, 1), (6, 0), (8, 1), (8, 3)])
def test_flooding_and_k2_kernels_match_plain(cuda, bg, Z, case, schedule, msg_dtype,
                                             in_dtype, n_iters, check_every):
    """Bits, ok flags and iteration counts equal the plain version's, for
    one iteration, early stop every first and third iteration, ties in |v|,
    -0.0 and zeros.  K2 runs n_iters iterations whatever check_every is."""
    g = ldpc.build_graph(bg, Z)
    _, llr = _awgn_llr(g, 16, seed=7 + Z, snr_db=(0.0, 4.0), case=case)
    x = torch.as_tensor(llr, device=cuda).to(in_dtype)
    name = ldpc_decoder.kernel_name(schedule, msg_dtype)
    n0 = ldpc_decoder.launches[name]
    kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=check_every,
              return_iters=True)
    bk, okk, ik = ldpc_decoder.decode(g, x, n_iters, **kw)
    bp, okp, ip = ldpc_decoder.decode_plain(g, x, n_iters, **kw)
    torch.cuda.synchronize()
    assert ldpc_decoder.launches[name] == n0 + 1
    assert torch.equal(bk, bp) and torch.equal(okk, okp) and torch.equal(ik, ip)
    if name == "layered_bf16":
        assert bool((ik == n_iters).all())


@pytest.mark.parametrize("bg,Z,n_cb", [(1, 384, 1), (2, 104, 1), (1, 384, 208)])
@pytest.mark.parametrize("schedule,msg_dtype,in_dtype", REDESIGNED)
def test_flooding_and_k2_kernels_at_one_and_208_code_blocks(cuda, bg, Z, n_cb, schedule,
                                                            msg_dtype, in_dtype):
    g = ldpc.build_graph(bg, Z)
    info, llr = _awgn_llr(g, n_cb, seed=n_cb + Z, snr_db=2.0)
    x = torch.as_tensor(llr, device=cuda).to(in_dtype)
    for check_every in (0, 1):
        kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=check_every,
                  return_iters=True)
        got = ldpc_decoder.decode(g, x, 8, **kw)
        want = ldpc_decoder.decode_plain(g, x, 8, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), check_every


@pytest.mark.parametrize("n_iters", [0, 1, 8])
def test_k2_kernel_on_signed_zeros(cuda, n_iters):
    """K2 on inputs of nothing but +0.0 and -0.0: the sign bit is the sign,
    so a -0.0 total gives bit 0 and yet a failing parity flag, as in the
    plain version."""
    g = ldpc.build_graph(2, 64)
    rng = np.random.default_rng(n_iters)
    llr = np.where(rng.random((12, g.cols * g.Z)) < 0.5, -0.0, 0.0).astype(np.float32)
    llr[:4] = 0.0                                 # all +0.0: the zero codeword
    llr[4:6] = -0.0                               # all -0.0
    x = torch.as_tensor(llr, device=cuda)
    kw = dict(msg_dtype=torch.bfloat16, return_iters=True)
    bk, okk, ik = ldpc_decoder.decode(g, x, n_iters, **kw)
    bp, okp, ip = ldpc_decoder.decode_plain(g, x, n_iters, **kw)
    assert torch.equal(bk, bp) and torch.equal(okk, okp) and torch.equal(ik, ip)
    assert not bool(bk.any()) and bool(okk[:4].all())
    if n_iters == 0:
        assert not bool(okk[4:].any())            # -0.0 totals: parity fails


@pytest.mark.parametrize("name,shape", [("tiny", (8, 128)), ("tiny_grid", (8, 8, 128))])
def test_tiny_kernels_match_plain(cuda, name, shape):
    from openairinterface5g_tpu_torch.ops import tiny
    x = torch.randn(shape, device=cuda)
    n0 = tiny.launches[name]
    got = getattr(tiny, name)(x)
    torch.cuda.synchronize()
    assert tiny.launches[name] == n0 + 1
    assert torch.equal(got, tiny.tiny_plain(x))
    with pytest.raises(ValueError):
        getattr(tiny, name)(torch.randn((4, 128), device=cuda))


# --------------------------------------------------------------------------
# the launch route: PyTorch's current stream, side streams, graph capture
# --------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["default stream", "side stream", "graph capture"])
def test_raw_stream_is_the_current_stream(cuda, where):
    from openairinterface5g_tpu_torch.ops import _cuda
    r = _cuda.route()
    seen = []

    def look():
        seen.append((r.stream(cuda.index), torch.cuda.current_stream(cuda).cuda_stream))

    if where == "default stream":
        look()
    elif where == "side stream":
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side):
            look()
        assert seen[0][0] == side.cuda_stream
    else:
        x = torch.zeros((8, 128), device=cuda)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            look()
            x.mul_(2)
        assert seen[0][0] != torch.cuda.default_stream(cuda).cuda_stream
    [(raw, current)] = seen
    assert raw == current


def _side_stream_case(kernel, dev):
    """(kernel output, plain output, launch count before and after) of one
    kernel run on a side stream whose input was produced on that stream."""
    from openairinterface5g_tpu_torch.ops import tiny
    rng = np.random.default_rng(11)
    if kernel in ("tiny", "tiny_grid"):
        shape = (8, 128) if kernel == "tiny" else (8, 8, 128)
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev) * 3.0
        n0 = tiny.launches[kernel]
        return getattr(tiny, kernel)(x), tiny.tiny_plain(x), n0, lambda: tiny.launches[kernel]
    if kernel == "decode":
        g = ldpc.build_graph(1, 384)
        _, llr = _awgn_llr(g, 9, seed=17, snr_db=1.0)
        x = torch.as_tensor(llr, device=dev) * 1.0
        n0 = ldpc_decoder.launches["layered_f32"]
        got = ldpc_decoder.decode(g, x, 6, check_every=1)
        return got, ldpc_decoder.decode_plain(g, x, 6, check_every=1), n0, \
            lambda: ldpc_decoder.launches["layered_f32"]
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2)
    y = _rx_grid(cfg, dev, seed=13)
    n0 = fe.launches
    return fe.frontend_planes(cfg, y), fe.frontend_planes_plain(cfg, y), n0, lambda: fe.launches


@pytest.mark.parametrize("kernel", ["tiny", "tiny_grid", "decode", "frontend"])
def test_kernel_on_a_side_stream(cuda, kernel):
    """T1, T2, K1 and K3 launched under torch.cuda.stream(side) run on that
    stream, after the op that made their input there."""
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got, ref, n0, count = _side_stream_case(kernel, cuda)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert count() == n0 + 1
    if kernel == "frontend":
        assert float((got - ref).abs().max() / ref.abs().max()) < 2e-4
    elif kernel == "decode":
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("name,shape", [("tiny", (8, 128)), ("tiny_grid", (8, 8, 128))])
def test_tiny_kernels_in_a_cuda_graph(cuda, name, shape):
    """T1/T2 captured in a CUDA graph and replayed on new input give x * 2."""
    from openairinterface5g_tpu_torch.ops import tiny
    fn = getattr(tiny, name)
    x = torch.randn(shape, device=cuda)
    fn(x)                                       # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x)
    for _ in range(2):
        x.copy_(torch.randn(shape, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, x * 2)


# --------------------------------------------------------------------------
# slice 9: the control channels and UCI on PUSCH on the card (plain PyTorch
# on CUDA tensors, K3 and K1 for UCI on PUSCH) against the same code on the CPU
# --------------------------------------------------------------------------

POLAR_CODES = [(dict(K=56, E=864, n_max=9, i_il=True), "24C"),
               (dict(K=64, E=216, n_max=9, i_il=True), "24C"),
               (dict(K=22, E=240, n_max=10, i_il=False, n_pc=3, i_bil=True), "6"),
               (dict(K=51, E=200, n_max=10, i_il=False, i_bil=True), "11")]


def _both(fn, *arrays, cuda):
    """fn on CPU tensors and on CUDA tensors of the same numpy arrays."""
    return (fn(*[torch.as_tensor(a) for a in arrays]),
            fn(*[torch.as_tensor(a, device=cuda) for a in arrays]))


def _equal(cpu, gpu):
    assert torch.equal(cpu, gpu.cpu())


@pytest.mark.parametrize("kw,crc", POLAR_CODES)
def test_polar_on_the_card_matches_cpu(cuda, kw, crc):
    """Encode equal; SCL candidates, chosen payload and CRC flags equal, the
    metrics within 1e-4 of the largest live one (all-zero and pure-noise
    rows included)."""
    from openairinterface5g_tpu_torch.coding import polar
    p = polar.polar_params(**kw)
    rng = np.random.default_rng(p.K)
    pay = rng.integers(0, 2, (16, p.K)).astype(np.int8)
    enc, enc_g = _both(lambda x: polar.encode(p, x), pay, cuda=cuda)
    _equal(enc, enc_g)
    llr = ((1 - 2.0 * enc.numpy()) * 2 + 1.5 * rng.standard_normal(enc.shape)).astype(np.float32)
    llr[-2] = rng.standard_normal(p.E)
    llr[-1] = 0.0
    (c, m), (cg, mg) = _both(lambda x: polar.scl_decode(p, polar.rate_recover_llr(p, x), 8), llr,
                             cuda=cuda)
    _equal(c, cg)
    live = m < 1e8
    assert float((m - mg.cpu()).abs().max()) <= 1e-4 * float(m[live].abs().max())
    (s, ok), (sg, okg) = _both(lambda x: polar.decode_with_crc(p, x, crc), llr, cuda=cuda)
    _equal(s, sg)
    _equal(ok, okg)


def test_control_channels_on_the_card_match_cpu(cuda):
    """PDCCH, SSB, initial sync, PUCCH F0-F4 and PRACH: the same inputs
    decode to the same outputs on the card as on the CPU."""
    from openairinterface5g_tpu_torch.config import make_frame_params
    from openairinterface5g_tpu_torch.models import pbch, pdcch, prach, pucch, sync
    rng = np.random.default_rng(9)

    def noisy(tx, n_rx=2, sigma=0.3):
        shape = (tx.shape[0], n_rx) + tx.shape[1:]
        n = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
        return (tx[:, None] * np.exp(0.4j) + sigma * n).astype(np.complex64)

    cs = pdcch.CoresetConfig(n_prb=48, interleaved=True, reg_bundle_size=6, interleaver_rows=2)
    dci = pdcch.DciConfig(A=39, aggregation_level=8, rnti=0x4601, coreset=cs, cce_index=0)
    pay = rng.integers(0, 2, (4, 39)).astype(np.int8)
    rx = noisy(pdcch.pdcch_tx_grid(dci, torch.as_tensor(pay)).numpy())
    (b, f, a), (bg, fg, ag) = _both(lambda x: pdcch.blind_search(
        x, 39, 0x4601, aggregation_levels=(4, 8), coreset=cs), rx, cuda=cuda)
    for x, y in ((b, bg), (f, fg), (a, ag)):
        _equal(x, y)
    assert bool(f.all()) and torch.equal(b, torch.as_tensor(pay))

    cfg = pbch.PbchConfig(n_id=77, i_ssb=1)
    pay = rng.integers(0, 2, (4, 32)).astype(np.int8)
    tile = pbch.ssb_generate(cfg, torch.as_tensor(pay))
    (g, ok), (gg, okg) = _both(lambda x: pbch.ssb_receive(cfg, x), noisy(tile.numpy()), cuda=cuda)
    _equal(g, gg)
    _equal(ok, okg)
    fp = make_frame_params(1, 24)
    ssb = sync.ssb_time_signal(fp, tile).numpy()
    stream = 0.1 * (rng.standard_normal((4, ssb.shape[-1] + 900))
                    + 1j * rng.standard_normal((4, ssb.shape[-1] + 900)))
    stream[:, 300: 300 + ssb.shape[-1]] += ssb
    stream = (stream * np.exp(2j * np.pi * 9000.0 * np.arange(stream.shape[-1]) / fp.sample_rate)
              ).astype(np.complex64)
    o, og = _both(lambda x: sync.initial_sync(fp, x, cfo_scan=1), stream, cuda=cuda)
    _equal(o["t0"], og["t0"])
    _equal(o["n_id"], og["n_id"])
    assert float((o["cfo_hz"] - og["cfo_hz"].cpu()).abs().max()) < 1e-3 * fp.scs

    for pcfg, uci in ((pucch.Pucch0Config(n_bits=2), rng.integers(0, 4, 8)),
                      (pucch.Pucch1Config(n_bits=2), rng.integers(0, 4, 8)),
                      (pucch.Pucch2Config(n_bits=64, n_prb=16),
                       rng.integers(0, 2, (8, 64)).astype(np.int8)),
                      (pucch.Pucch34Config(fmt=3, n_bits=11, n_prb=4),
                       rng.integers(0, 2, (8, 11)).astype(np.int8)),
                      (pucch.Pucch34Config(fmt=4, n_bits=9, occ_len=4, occ_index=1),
                       rng.integers(0, 2, (8, 9)).astype(np.int8))):
        tx_fn, rx_fn = ((pucch.pucch0_tx, pucch.pucch0_rx) if isinstance(pcfg, pucch.Pucch0Config)
                        else (pucch.pucch1_tx, pucch.pucch1_rx)
                        if isinstance(pcfg, pucch.Pucch1Config)
                        else (pucch.pucch2_tx, pucch.pucch2_rx)
                        if isinstance(pcfg, pucch.Pucch2Config)
                        else (pucch.pucch34_tx, pucch.pucch34_rx))
        tx_c, tx_g = _both(lambda u: tx_fn(pcfg, u), uci, cuda=cuda)
        assert float((tx_c - tx_g.cpu()).abs().max()) <= 1e-6
        (u_c, _), (u_g, _) = _both(lambda x: rx_fn(pcfg, x), noisy(tx_c.numpy()), cuda=cuda)
        _equal(u_c, u_g)
        assert torch.equal(u_c, torch.as_tensor(uci).to(u_c.dtype))

    td = prach.PrachTdConfig(fmt="A2", mu=1, sample_rate=122.88e6, roots=prach.nr_roots(1, 16, 139),
                             n_cs=34)
    pre = rng.integers(0, 64, 8)
    tx = prach.prach_td_tx(td, torch.as_tensor(pre)).numpy()
    d_c, d_g = _both(lambda x: prach.prach_td_rx(td, x), noisy(tx, sigma=3.0), cuda=cuda)
    for k in ("detected", "preamble", "delay"):
        _equal(d_c[k], d_g[k])
    assert torch.equal(d_c["preamble"], torch.as_tensor(pre))
    assert float((d_c["metric"] / d_g["metric"].cpu() - 1).abs().max()) < 1e-4


def test_uci_on_pusch_through_k1_and_k3(cuda):
    """UCI on PUSCH at 24 PRB, 2x2: K3 and K1 launch once each; TB, ACK and
    both CSI parts equal the CPU run's (the unfused chain) and the sent bits."""
    from openairinterface5g_tpu_torch.models.uci_on_pusch import UciOnPuschConfig
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2,
                            decoder_backend="kernel", decoder_check_every=1)
    ucfg = UciOnPuschConfig(n_ack_bits=6, n_csi1_bits=16, n_csi2_bits=40)
    rng = np.random.default_rng(4)
    tb = rng.integers(0, 2, (4, cfg.tbs)).astype(np.int8)
    bits = [rng.integers(0, 2, (4, n)).astype(np.int8) for n in (6, 16, 40)]
    tx, _ = pusch.pusch_tx(cfg, torch.as_tensor(tb), uci_cfg=ucfg, ack_bits=torch.as_tensor(bits[0]),
                           csi1_bits=torch.as_tensor(bits[1]), csi2_bits=torch.as_tensor(bits[2]))
    n = rng.standard_normal((2, *tx.shape)).astype(np.float32)
    rx = (tx + 0.1 * tx.flip(1) + 0.05 * torch.complex(torch.as_tensor(n[0]),
                                                       torch.as_tensor(n[1]))).numpy()
    out_c = pusch.pusch_rx(cfg, torch.as_tensor(rx), n_iters=8, uci_cfg=ucfg)
    f0, d0 = fe.launches, ldpc_decoder.launches["layered_f32"]
    out_g = pusch.pusch_rx(cfg, torch.as_tensor(rx, device=cuda), n_iters=8, uci_cfg=ucfg)
    torch.cuda.synchronize()
    assert fe.launches == f0 + 1 and ldpc_decoder.launches["layered_f32"] == d0 + 1
    for k in ("tb_ok", "tb_bits", "ack_bits"):
        _equal(out_c[k], out_g[k])
    for k in out_c["uci"]:
        _equal(out_c["uci"][k], out_g["uci"][k])
    assert bool(out_g["tb_ok"].all()) and torch.equal(out_c["tb_bits"], torch.as_tensor(tb))
    for name, sent in zip(("ack", "csi1", "csi2"), bits):
        assert torch.equal(out_c["uci"][name], torch.as_tensor(sent))


def test_turbo_on_the_card_matches_cpu(cuda):
    """The turbo encoder bit-equal on the card; the decoder's bits equal and
    its LLRs within 1e-3 of the CPU run's (K = 40 and 1024, 0.5 dB)."""
    from openairinterface5g_tpu_torch.coding import turbo
    rng = np.random.default_rng(12)
    for K in (40, 1024):
        bits = rng.integers(0, 2, (6, K)).astype(np.int8)
        d_c, d_g = _both(turbo.encode, bits, cuda=cuda)
        for a, b in zip(d_c, d_g):
            _equal(a, b)
        sigma = 10 ** (-0.5 / 20)
        llrs = [(2 / sigma ** 2 * ((1 - 2 * x.numpy().astype(np.float32))
                                   + sigma * rng.standard_normal(x.shape))).astype(np.float32)
                for x in d_c]
        (b_c, l_c), (b_g, l_g) = _both(turbo.decode, *llrs, cuda=cuda)
        _equal(b_c, b_g)
        assert float((l_c - l_g.cpu()).abs().max()) <= 1e-3 * float(l_c.abs().max())


def test_lte_chains_on_the_card_match_cpu(cuda):
    """LTE PDSCH (two code blocks with filler) and PUSCH (2 RX): TX samples
    within 1e-5 of the CPU's, RX tb_ok and TB bits equal and equal to the
    sent ones, LLRs within 1e-4."""
    from openairinterface5g_tpu_torch.lte import pdsch as lte_pdsch
    from openairinterface5g_tpu_torch.lte import pusch as lte_pusch
    rng = np.random.default_rng(13)
    for cfg, tx_fn, rx_fn in (
            (lte_pdsch.LtePdschConfig(n_rb=25, n_prb=25, mcs=28, tbs_override=6208, n_rx=2),
             lte_pdsch.pdsch_tx, lte_pdsch.pdsch_rx),
            (lte_pusch.LtePuschConfig(n_rb=6, n_prb=6, mcs=16, n_rx=2),
             lte_pusch.pusch_tx, lte_pusch.pusch_rx)):
        tb = rng.integers(0, 2, (3, cfg.tbs)).astype(np.int8)
        (tx_c, s_c), (tx_g, s_g) = _both(lambda t: tx_fn(cfg, t), tb, cuda=cuda)
        _equal(s_c, s_g)
        assert float((tx_c - tx_g.cpu()).abs().max()) <= 1e-5 * float(tx_c.abs().max())
        x = tx_c.numpy()
        rx = (np.concatenate([x, (0.6 + 0.3j) * x], axis=1)
              + 0.03 * (rng.standard_normal((3, 2, x.shape[-1]))
                        + 1j * rng.standard_normal((3, 2, x.shape[-1])))).astype(np.complex64)
        o_c, o_g = _both(lambda r: rx_fn(cfg, r), rx, cuda=cuda)
        for k in ("tb_ok", "cb_ok", "tb_bits"):
            _equal(o_c[k], o_g[k])
        assert torch.equal(o_c["tb_bits"], torch.as_tensor(tb))
        assert float((o_c["llrs"] - o_g["llrs"].cpu()).abs().max()) \
            <= 1e-4 * float(o_c["llrs"].abs().max())


def test_slot_models_on_the_card_match_cpu(cuda):
    """SRS, PRS and MU-MIMO (K1 pinned), and the gNB DL/UL and UE slots at 24
    PRB: the card's outputs equal the CPU's (the CPU runs the plain versions
    of K3 and K1), K1 and K3 launching where their configurations take them."""
    from openairinterface5g_tpu_torch.config import make_frame_params
    from openairinterface5g_tpu_torch.models import (csirs, gnb, mu_mimo, pbch, pdcch, pdsch,
                                                     prach, prs, pucch, srs, ue)
    from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate
    rng = np.random.default_rng(14)

    def cplx(shape, s=1.0):
        return (s * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
            np.complex64)

    scfg = srs.SrsConfig(n_prb=24, n_ports=2)
    sig = np.einsum("brp,bpk->brk", cplx((4, 2, 2)), srs.srs_tx(scfg, 4, "cpu").numpy())
    r_c, r_g = _both(lambda x: srs.srs_report(scfg, x), (sig + cplx(sig.shape, 0.05)), cuda=cuda)
    _equal(r_c["pmi"], r_g["pmi"])
    assert float((r_c["wideband_snr_db"] - r_g["wideband_snr_db"].cpu()).abs().max()) < 1e-3
    pcfg = prs.PrsConfig(n_prb=24)
    tile = prs.prs_tx_grid(pcfg, 4, 288, "cpu").numpy()[:, None]
    t_c, t_g = _both(lambda x: prs.prs_toa(pcfg, x, 512)["toa_samples"],
                     (tile * np.exp(-2j * np.pi * np.arange(288) * 3.3 / 512)
                      + cplx((4, 2, 4, 288), 0.1)).astype(np.complex64), cuda=cuda)
    assert float((t_c - t_g.cpu()).abs().max()) < 1e-3

    c1, c2 = (dataclasses.replace(c, decoder_backend="kernel") for c in mu_mimo.mu_cfgs(24, 1, 2))
    tbs = [rng.integers(0, 2, (4, c.tbs)).astype(np.int8) for c in (c1, c2)]
    tx = mu_mimo.mu_mimo_tx(c1, c2, *(torch.as_tensor(t) for t in tbs), 0, 1).numpy()
    rx = (tx + 0.1 * tx[:, ::-1] + cplx(tx.shape, 0.02)).astype(np.complex64)
    f0, d0 = fe.launches, ldpc_decoder.launches["layered_f32"]
    o_c, o_g = _both(lambda x: mu_mimo.mu_mimo_rx(c1, 0, x, n_iters=8), rx, cuda=cuda)
    torch.cuda.synchronize()
    assert fe.launches == f0 and ldpc_decoder.launches["layered_f32"] == d0 + 1
    _equal(o_c["tb_bits"], o_g["tb_bits"])
    assert torch.equal(o_c["tb_bits"], torch.as_tensor(tbs[0]))

    pd = pdsch.PdschConfig(mu=1, n_prb=4, prb_start=20, n_bwp_prb=24, mcs=9, rnti=0x4321,
                           start_symbol=2, n_symbols=12, dmrs_symbols=(2,))
    dl = gnb.SlotDlConfig(mu=1, n_bwp_prb=24, pdsch=(pd,),
                          ssb=gnb.SsbPdu(pbch.PbchConfig(n_id=0), start_symbol=8),
                          pdcch=(gnb.PdcchPdu(pdcch.DciConfig(A=ue.DCI_A, rnti=0x4321,
                                                              coreset_prb=6,
                                                              aggregation_level=1)),),
                          csirs=(gnb.CsirsPdu(csirs.CsirsConfig(n_prb=24, symbol=1)),))
    tb = rng.integers(0, 2, (2, pd.tbs)).astype(np.int8)
    mib = rng.integers(0, 2, (2, 32)).astype(np.int8)
    dci = np.tile(ue.encode_grant(mcs=9, prb_start=20, n_prb=4), (2, 1))
    (tx_c, _), (tx_g, _) = _both(lambda a, b, c: gnb.gnb_dl_slot(dl, [a], b, dci_payloads=[c]),
                                 tb, mib, dci, cuda=cuda)
    assert float((tx_c - tx_g.cpu()).abs().max()) <= 1e-5 * float(tx_c.abs().max())
    fp = make_frame_params(1, 24)
    grid = extract_from_grid(fp, ofdm_demodulate(fp, tx_c, 0)).numpy()
    ucfg = ue.UeConfig(mu=1, n_bwp_prb=24, rnti=0x4321, coreset_prb=6)
    f0 = fe.launches
    u_c, u_g = _both(lambda g: ue.ue_receive_slot(ucfg, g), grid + cplx(grid.shape, 0.03),
                     cuda=cuda)
    torch.cuda.synchronize()
    assert fe.launches == f0 + 1 and u_c["grant"] == u_g["grant"]
    for k in ("dci_found", "tb_ok", "tb_bits"):
        _equal(u_c[k], u_g[k])
    assert torch.equal(u_c["tb_bits"], torch.as_tensor(tb))

    pu = pusch.PuschConfig(mu=1, n_prb=16, n_bwp_prb=24, mcs=9, n_symbols=13, n_rx=2,
                           decoder_backend="kernel")
    p0, p2 = pucch.Pucch0Config(n_bits=1), pucch.Pucch2Config(n_bits=6, n_prb=2)
    ul = gnb.SlotUlConfig(mu=1, n_bwp_prb=24, pusch=(pu,), pucch0=((p0, 18),),
                          pucch2=((p2, 20),), prach=(prach.PrachConfig(),))
    tbu = torch.as_tensor(rng.integers(0, 2, (2, pu.tbs)).astype(np.int8))
    g, _ = pusch.pusch_tx_grid(pu, tbu)
    g = gnb.place_pucch_tile(g, pucch.pucch0_tx(p0, torch.tensor([0, 1])), p0, 18)
    g[:, 0, 13, 240: 264] += pucch.pucch2_tx(p2, torch.ones((2, 6), dtype=torch.int8))[:, 0]
    from openairinterface5g_tpu_torch.phy.ofdm import map_to_grid, ofdm_modulate
    x = ofdm_modulate(fp, map_to_grid(fp, g), 0).numpy()
    x = np.concatenate([x, 0.5j * x], axis=1) + cplx((2, 2, x.shape[-1]), 0.01)
    pf = prach.prach_tx(prach.PrachConfig(), torch.tensor([5, 17])).numpy()[:, None]
    f0, d0 = fe.launches, ldpc_decoder.launches["layered_f32"]
    o_c, o_g = _both(lambda a, b: gnb.gnb_ul_slot(ul, a, n_iters=8, prach_freq=b),
                     x.astype(np.complex64), pf.astype(np.complex64), cuda=cuda)
    torch.cuda.synchronize()
    assert fe.launches == f0 + 1 and ldpc_decoder.launches["layered_f32"] == d0 + 1
    _equal(o_c["rx_data"][0], o_g["rx_data"][0])
    assert torch.equal(o_c["rx_data"][0], tbu)
    _equal(o_c["uci0"][0]["uci"], o_g["uci0"][0]["uci"])
    _equal(o_c["uci2"][0]["uci"], o_g["uci2"][0]["uci"])
    _equal(o_c["rach_indication"][0]["preamble"], o_g["rach_indication"][0]["preamble"])


# --------------------------------------------------------------------------
# slice 11: the LTE control channels and NB-IoT on the card (plain PyTorch on
# CUDA tensors) against the same code on the CPU
# --------------------------------------------------------------------------

def _crandn(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def test_viterbi_on_the_card_matches_cpu(cuda):
    """Encode and decode bit-equal on the card, the all-zero (all-tie) input,
    integer LLRs (near-ties) and punctured LLRs included."""
    from openairinterface5g_tpu_torch.coding import viterbi
    rng = np.random.default_rng(21)
    for L in (40, 43, 120):
        bits = rng.integers(0, 2, (8, L)).astype(np.int8)
        e_c, e_g = _both(viterbi.encode, bits, cuda=cuda)
        _equal(e_c, e_g)
        llr = (2.0 * (1.0 - 2.0 * e_c.numpy()) + 2.0 * rng.standard_normal(e_c.shape))
        llr[0] = 0.0
        llr[1] = np.round(llr[1])
        llr[2, rng.random(3 * L) < 0.3] = 0.0
        d_c, d_g = _both(viterbi.decode, llr.astype(np.float32), cuda=cuda)
        _equal(d_c, d_g)
        assert (d_c.numpy()[3:] == bits[3:]).mean() > 0.9


def test_lte_control_on_the_card_matches_cpu(cuda):
    """PBCH (1/2/4 ports), the PDCCH blind search (two RNTIs, a wrong one),
    PUCCH 1a/1b/2, PRACH and SRS: decisions equal, metrics, d_hat and
    estimates within the CPU tests' tolerances."""
    from openairinterface5g_tpu_torch.lte import pbch, pdcch, prach, pucch, srs
    rng = np.random.default_rng(22)
    for ports in (1, 2, 4):
        cfg = pbch.LtePbchConfig(n_rb=25, cell_id=17, n_tx_ports=ports, n_rx=2)
        mib = rng.integers(0, 2, (3, 24)).astype(np.int8)
        g_c, g_g = _both(lambda m: pbch.pbch_tx_grids(cfg, m), mib, cuda=cuda)
        assert float((g_c - g_g.cpu()).abs().max()) <= 1e-6
        h = _crandn(rng, (3, 2, 300))
        rx = h[:, None, :, None, :] * g_c.numpy()[:, :, None] + _crandn(rng, (3, 4, 2, 14, 300), 0.1)
        o_c, o_g = _both(lambda r, hh: pbch.pbch_rx_grids(cfg, r, hh), rx, h, cuda=cuda)
        for a, b in zip(o_c, o_g):
            _equal(a, b)
        assert bool(o_c[1].all()) and (o_c[2] == ports).all()
    A, n_rb, cell, sf = 27, 50, 7, 1
    pays = [rng.integers(0, 2, (3, A)).astype(np.int8) for _ in range(2)]
    y0 = sum(pdcch.pdcch_tx_symbol0(n_rb, cell, sf, torch.as_tensor(p), r, al, c0).numpy()
             for p, r, al, c0 in ((pays[0], 0x5678, 2, 0), (pays[1], 0x1234, 4, 4)))
    h = np.broadcast_to(_crandn(rng, (3, 1, 1)), (3, 1, 600)).copy()
    y = h * y0[:, None] + _crandn(rng, (3, 1, 600), 0.1)
    for rnti, sent in ((0x5678, pays[0]), (0x1234, pays[1]), (0x0BAD, None)):
        o_c, o_g = _both(lambda a, b: pdcch.pdcch_blind_decode(a, b, n_rb, cell, sf, rnti, A),
                         y, h, cuda=cuda)
        for a, b in zip(o_c, o_g):
            _equal(a, b)
        assert bool(o_c[1].all()) == (sent is not None)
    for n_bits, kw in ((1, dict(n_oc=1, cs0=2)), (2, dict(n_oc=2, cs0=5))):
        cfg = pucch.LtePucch1Config(n_rb=25, cell_id=17, prb=3, n_rx=2, **kw)
        bits = rng.integers(0, 2, (8, n_bits)).astype(np.int8)
        grid = pucch.pucch1_tx(cfg, torch.as_tensor(bits)).numpy()
        rx = _crandn(rng, (8, 2, 1, 1)) * grid[:, None] + _crandn(rng, (8, 2, 14, 300), 0.2)
        o_c, o_g = _both(lambda r: pucch.pucch1_rx(cfg, r, n_bits), rx, cuda=cuda)
        assert float((o_c["d_hat"] - o_g["d_hat"].cpu()).abs().max()) \
            <= 1e-5 * float(o_c["d_hat"].abs().max())
        _equal(o_c["bits"], o_g["bits"])
        _equal(o_c["detected"], o_g["detected"])
    for n_bits in (4, 13):
        cfg = pucch.LtePucch2Config(n_rb=25, cell_id=17, prb=1, cs0=3, n_bits=n_bits)
        bits = rng.integers(0, 2, (8, n_bits)).astype(np.int8)
        rx = pucch.pucch2_tx(cfg, torch.as_tensor(bits)).numpy()[:, None] \
            + _crandn(rng, (8, 1, 14, 300), 0.15)
        o_c, o_g = _both(lambda r: pucch.pucch2_rx(cfg, r), rx, cuda=cuda)
        _equal(o_c["uci"], o_g["uci"])
        _equal(o_c["detected"], o_g["detected"])
        assert torch.equal(o_c["uci"], torch.as_tensor(bits))
    for fmt in range(4):
        cfg = prach.LtePrachConfig(format=fmt, root_sequence_index=22 + 5 * fmt)
        idx = rng.integers(0, cfg.n_preambles, 8)
        tx = prach.prach_tx(cfg, torch.as_tensor(idx)).numpy()
        rx = tx[:, None] + _crandn(rng, (8, 2, 839), 0.3)
        o_c, o_g = _both(lambda r: prach.prach_rx(cfg, r), rx, cuda=cuda)
        for k in ("detected", "preamble", "delay"):
            _equal(o_c[k], o_g[k])
        assert float((o_c["metric"] - o_g["metric"].cpu()).abs().max()) \
            <= 1e-5 * float(o_c["metric"].abs().max())
    cfg = srs.LteSrsConfig(n_rb=100, srs_rb=96, cell_id=7, cyclic_shift=3, n_rx=2)
    y = _crandn(rng, (4, 2, 1)) * srs.srs_tx(cfg, 4).numpy()[:, None] + _crandn(rng, (4, 2, 1200), 0.05)
    o_c, o_g = _both(lambda r: srs.srs_rx(cfg, r), y, cuda=cuda)
    for k in ("h", "snr_db", "noise_var"):
        assert float((o_c[k] - o_g[k].cpu()).abs().max()) <= 1e-5 * float(o_c[k].abs().max()), k


def test_nbiot_on_the_card_matches_cpu(cuda, capsys):
    """NSSS identification, NPBCH, NPDSCH, NPUSCH and NPRACH decide as on the
    CPU, and the simulator prints the CPU run's lines."""
    from openairinterface5g_tpu_torch.lte import nbiot
    from openairinterface5g_tpu_torch.sim import nbiotsim
    rng = np.random.default_rng(23)
    g = nbiot.nsss_insert(torch.zeros((4, 14, 12), dtype=torch.complex64), 133, 0).numpy()
    y = g + _crandn(rng, g.shape, 0.4)
    (i_c, m_c), (i_g, m_g) = _both(lambda x: nbiot.nsss_identify(x, range(120, 150)), y, cuda=cuda)
    _equal(i_c, i_g)
    assert float((m_c - m_g.cpu()).abs().max()) <= 1e-5 * float(m_c.abs().max())
    cfg = nbiot.NbConfig(n_id=133, n_reps=8)
    t = nbiot.npbch_tx(cfg, torch.as_tensor(rng.integers(0, 2, (4, 34)).astype(np.int8))).numpy()
    o_c, o_g = _both(lambda x: nbiot.npbch_rx(cfg, x), t + _crandn(rng, t.shape, 1.2), cuda=cuda)
    _equal(o_c["mib_bits"], o_g["mib_bits"])
    _equal(o_c["ok"], o_g["ok"])
    for ul in (False, True):
        c = nbiot.NbSchConfig(tbs=256, n_sf=2, n_reps=4, ul=ul)
        t = nbiot.nbsch_tx(c, torch.as_tensor(rng.integers(0, 2, (4, 256)).astype(np.int8))).numpy()
        o_c, o_g = _both(lambda x: nbiot.nbsch_rx(c, x), t + _crandn(rng, t.shape, 0.6), cuda=cuda)
        _equal(o_c["tb_bits"], o_g["tb_bits"])
        _equal(o_c["ok"], o_g["ok"])
    pc = nbiot.NprachConfig()
    t = nbiot.nprach_tx(pc, 5, batch=4).numpy()
    o_c, o_g = _both(lambda x: nbiot.nprach_detect(pc, x), t + _crandn(rng, t.shape, 0.25), cuda=cuda)
    _equal(o_c["n_init"], o_g["n_init"])
    _equal(o_c["detected"], o_g["detected"])
    assert nbiotsim.main(["-n", "8", "--device", "cpu"]) == 0
    cpu = capsys.readouterr().out
    assert nbiotsim.main(["-n", "8"]) == 0
    assert capsys.readouterr().out == cpu


def test_executor_at_depth_2_on_the_card(cuda):
    """The slot executor on its own CUDA stream: results in order, on the
    host, and every slot's enqueue shorter than its completion."""
    from openairinterface5g_tpu_torch.runtime import executor

    def step(i, x):
        for _ in range(20):
            x = x @ x / 512
        return {"i": i, "v": x.sum()}
    xs = [(torch.full((512, 512), 1.0 / 512, device=cuda) * (1 + i / 8),) for i in range(8)]
    ex = executor.SlotExecutor(step, depth=2, slot_duration_s=500e-6, device=cuda)
    got = ex.run(xs)
    assert [r["i"] for r in got] == list(range(8))
    assert all(r["v"].device.type == "cpu" for r in got)
    want = [step(i, *x)["v"].cpu() for i, x in enumerate(xs)]
    for r, w in zip(got, want):
        assert torch.allclose(r["v"], w, rtol=1e-5)
    assert len(ex.stats) == 8 and all(s.dispatch_us < s.complete_us for s in ex.stats)


def test_executor_results_in_pinned_memory_on_the_card(cuda, monkeypatch):
    """On the card a call's results are copied at its hand-in into pinned
    host memory: under collect=True every result is its own pinned tensor,
    equal to a synchronous copy of the same step, in order; under
    collect=False run() returns None and no retired result outlives its
    retire, so the pinned blocks go back to the allocator's cache."""
    import weakref

    from openairinterface5g_tpu_torch.runtime import executor
    depth, calls = 2, 12
    base = torch.arange(3 << 20, device=cuda)

    def step(i):
        torch.cuda._sleep(1 << 20)         # the card still busy at the next hand-in
        bits = ((base * 7919 + i * 104729) % 251 % 2).to(torch.int8)
        return {"i": i, "bits": bits, "ok": bits[:64].bool()}

    got = executor.SlotExecutor(step, depth=depth, device=cuda).run([()] * calls)
    assert [r["i"] for r in got] == list(range(calls))
    host = [t for r in got for t in (r["bits"], r["ok"])]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in host)
    assert len({t.untyped_storage().data_ptr() for t in host}) == len(host)
    for i, r in enumerate(got):
        want = step(i)
        assert torch.equal(r["bits"], want["bits"].cpu()) and torch.equal(r["ok"], want["ok"].cpu())
    del got, host

    refs = []
    real = executor.to_host

    def to_host(out, **kw):
        res = real(out, **kw)
        refs.append(weakref.ref(res["bits"]))
        return res

    def watched(i):       # calls 0 .. i - 1 - depth have retired at call i's hand-in
        assert all(r() is None for r in refs[:max(0, i - depth)]), i
        return step(i)

    monkeypatch.setattr(executor, "to_host", to_host)
    ex = executor.SlotExecutor(watched, depth=depth, device=cuda)
    assert ex.run([()] * calls, collect=False) is None
    assert len(refs) == calls and all(r() is None for r in refs)
    assert [s.slot for s in ex.stats] == list(range(calls))


def test_softmodem_on_the_card_matches_cpu(cuda):
    """The softmodem at tests/test_runtime.py's loop arguments through K1
    (--backend kernel) and K3: the CPU run's UL TB ok list."""
    from openairinterface5g_tpu_torch.ops import ldpc_decoder
    from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
    from openairinterface5g_tpu_torch.runtime import softmodem
    argv = ["-n", "4", "-u", "1", "-P", "6", "-m", "4", "-s", "16", "-I", "6",
            "--backend", "kernel"]
    cpu = softmodem.run(softmodem.parse_args(argv + ["--device", "cpu"]), log=lambda *a: None)
    k1, k3 = ldpc_decoder.launches["layered_f32"], fe.launches
    card = softmodem.run(softmodem.parse_args(argv), log=lambda *a: None)
    assert card["ul_ok"] == cpu["ul_ok"] == [[True]] * 4
    assert ldpc_decoder.launches["layered_f32"] - k1 == 4 and fe.launches - k3 == 4


def test_ra_over_the_air_on_the_card(cuda):
    """gNB and UE on one card, each on a stream of its own: the JAX run's
    recorded lines (RA_OTA_r4.txt)."""
    import pathlib
    import threading

    from openairinterface5g_tpu_torch.ops import _cuda
    from openairinterface5g_tpu_torch.runtime import ra_ota
    _cuda.route()                       # build the kernels before the threads start
    lines, res = [], {}
    t = threading.Thread(target=lambda: res.__setitem__(
        "gnb", ra_ota.run_gnb(48751, log=lines.append)), daemon=True)
    t.start()
    res["ue"] = ra_ota.run_ue(48751, log=lines.append)
    t.join(timeout=300)
    assert res == {"gnb": True, "ue": True}
    record = (pathlib.Path(__file__).resolve().parents[1] / "RA_OTA_r4.txt").read_text()
    for role in ("[gnb]", "[ue]"):
        assert [x for x in lines if x.startswith(role)] == \
            [x for x in record.splitlines() if x.startswith(role)]


# ---- slice 13: the fronthaul codecs, the call flow's msg3, profiling, the executor ----

def _crandn_np(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
            ).astype(np.complex64)


def test_fronthaul_packers_on_the_card_match_cpu(cuda):
    """IF5 and the O-RAN U-plane: the same bytes packed on the card as on
    the CPU (a zero chunk and PRB, a short chunk, a power-of-two max, values
    past 2**15 included), and the same bits rebuilt on the card."""
    from openairinterface5g_tpu_torch.fronthaul import if5, oran
    rng = np.random.default_rng(13)
    x = _crandn_np(rng, (2, 7680), 0.3)
    x[1, 2048:4096] = 0
    x[0, 100] = 1.0
    x[1, 5000] = 1e5
    xc = torch.as_tensor(x)
    pkts = if5.slot_to_packets(if5.UL_TD, 7, 3, xc.to(cuda))
    assert pkts == if5.slot_to_packets(if5.UL_TD, 7, 3, xc)
    card = if5.packets_to_slot(pkts[::-1], 2, 7680, device=cuda)[3]
    cpu = if5.packets_to_slot(pkts[::-1], 2, 7680, device="cpu")[3]
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)
    g = _crandn_np(rng, (2, 14, 12 * 273), 2.3)
    g[0, 3, :12] = 0
    g[0, 4, :12] = 2.0
    g[1, 5, :12] = 4e4
    gc = torch.as_tensor(g)
    pk = oran.grid_to_uplane(gc.to(cuda), max_prb_per_pkt=64)
    assert len(pk) == 140 and pk == oran.grid_to_uplane(gc, max_prb_per_pkt=64)
    assert pk[:5] == oran.symbol_to_uplane(0, 0, 0, 0, 0, 0, gc[0, 0].to(cuda))
    card = oran.uplane_to_grid(pk[::-1], 2, 14, 12 * 273, device=cuda)
    assert torch.equal(card.cpu(), oran.uplane_to_grid(pk[::-1], 2, 14, 12 * 273, device="cpu"))
    u = oran.unpack_uplane(pk[7], device=cuda)
    assert u.iq.device.type == "cuda" and torch.equal(u.iq.cpu(),
                                                      oran.unpack_uplane(pk[7], device="cpu").iq)


def test_msg3_through_k3_and_k1(cuda):
    """The SA call flow's msg3 (an RRCSetupRequest in a 6-PRB MCS-4 PUSCH TB,
    12 iterations, tests/test_e2e_callflow.py) through K3 and K1 once each:
    the CPU's plain path's bits and the request recovered."""
    from openairinterface5g_tpu_torch.l3 import rrc
    sent = []
    ue = rrc.UeRrc(send_ul=lambda srb, pdu: sent.append(pdu))
    ue.connect(nas_pdu=b"")
    cfg = pusch.PuschConfig(mu=1, n_prb=6, mcs=4, n_layers=1, n_rx=1, rnti=0x4601,
                            decoder_backend="kernel")
    payload = np.frombuffer(len(sent[0]).to_bytes(2, "big") + sent[0], np.uint8)
    tb = np.zeros((1, cfg.tbs), np.int8)
    tb[0, : 8 * len(payload)] = np.unpackbits(payload)
    rng = np.random.default_rng(0)
    tx = pusch.pusch_tx(cfg, torch.as_tensor(tb))[0]
    rx = tx + torch.as_tensor(_crandn_np(rng, tuple(tx.shape), 0.02))
    cpu = pusch.pusch_rx(cfg, rx, n_iters=12)
    k1, k3 = ldpc_decoder.launches["layered_f32"], fe.launches
    card = pusch.pusch_rx(cfg, rx.to(cuda), n_iters=12)
    assert ldpc_decoder.launches["layered_f32"] - k1 == 1 and fe.launches - k3 == 1
    assert bool(card["tb_ok"][0]) and bool(cpu["tb_ok"][0])
    assert torch.equal(card["tb_bits"].cpu(), cpu["tb_bits"])
    bits = card["tb_bits"][0].cpu().numpy().astype(np.uint8)
    got = np.packbits(bits).tobytes()
    assert rrc.decode_ul(got[2: 2 + int.from_bytes(got[:2], "big")])[0] == "rrcSetupRequest"


def test_profiling_on_the_card(cuda, tmp_path):
    """profile_to's trace holds the trace() span and the card's rows (K3's);
    Meas.stop on a CUDA tensor waits for its stream."""
    import json

    from openairinterface5g_tpu_torch.utils import profiling
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=9, n_layers=1, n_rx=1)
    y = _rx_grid(cfg, cuda, seed=3, B=2)
    fe.frontend_planes(cfg, y)
    with profiling.profile_to(str(tmp_path)):
        with profiling.trace("card_frontend"):
            fe.frontend_planes(cfg, y)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert "card_frontend" in {e.get("name") for e in events}
    assert any(e.get("cat") == "kernel" and "frontend_kernel" in e["name"] for e in events)
    m = profiling.Meas("slow")
    x = torch.randn(2048, 2048, device=cuda)
    m.start()
    for _ in range(20):
        x = x @ x / 2048
    m.stop(x)
    assert torch.cuda.current_stream(cuda).query()


def test_program_spans_on_the_card(cuda, monkeypatch):
    """The tracer of utils/profiling.py in a traced executor run at
    nr40-pusch-2l2r-mcs16.clean32's shape (32 slots a call, depth 2, 23
    dB): benchmark/tracing.reduce gives the same layer_s keys with the
    program's spans and the benchmark's wrappers, with the wrappers alone
    and with the program's spans alone, the copies to the host under
    runtime/executor.py; K1 iterates once a code block; the in-flight mean
    lies within the depth; every result lands in pinned memory; every new
    reader reads."""
    import contextlib
    import types

    from benchmark import harness, load, nr, spec, tracing
    from openairinterface5g_tpu_torch.runtime.executor import SlotExecutor
    from openairinterface5g_tpu_torch.utils import profiling
    cell = spec.resolve("nr40-pusch-2l2r-mcs16.clean32")
    p = nr.Pusch.from_config(cell.config)
    pool, _ = load.make_pool(p, cell.traffic, 2**31 + 17, cuda)
    steps = harness.Steps(harness.program_config(cell.config), cell.config["n_iters"], [])
    ex = SlotExecutor(steps, depth=cell.traffic["depth"], device=cuda)
    ex.run([(a,) for a in pool], collect=False)

    def traced(wrappers: bool, program: bool) -> dict:
        profiling.reset()
        out: dict = {}
        with contextlib.ExitStack() as stack:
            if not program:       # the capture no longer switches the tracer on
                stack.enter_context(monkeypatch.context()).setattr(
                    profiling, "_torch_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
            if wrappers:
                stack.enter_context(tracing.layer_spans())
            stack.enter_context(tracing.captured(out))
            ex.run([(a,) for a in pool * 2], collect=False)
        return out

    both = traced(True, True)
    assert traced(True, False)["layer_s"].keys() == both["layer_s"].keys()
    alone = traced(False, True)
    assert alone["layer_s"].keys() == both["layer_s"].keys()
    assert tracing.OUTSIDE not in alone["layer_s"]
    run = harness.Run(p=p, traffic=cell.traffic, setup_s=0.0)
    got = {name: spec.reader(name)(run)
           for name in ("host_self_ms.ofdm", "host_self_ms.frontend", "host_self_ms.coding",
                        "host_self_ms.pusch", "retire_wait_ms", "retire_copy_ms",
                        "inflight_calls.mean", "k1_iters_per_cb", "retire_held_ms.p95",
                        "retire_pinned_share")}
    assert got.pop("k1_iters_per_cb") == 1.0
    assert got.pop("retire_pinned_share") == 1.0
    assert both["layer_s"]["runtime/executor.py"] > 0 and alone["layer_s"]["runtime/executor.py"] > 0
    assert 0 <= got.pop("inflight_calls.mean") <= cell.traffic["depth"]
    assert all(v > 0 for v in got.values()), got
    profiling.reset()


def test_inflight_counter_on_the_card(cuda):
    """The executor's in-flight counter: steps that keep the card busy
    longer than the host takes to hand them in read the depth once the
    pipeline has filled; a host read inside the step (the depth-0 fault
    the executor's docstring warns of) reads 0 at every hand-in."""
    from openairinterface5g_tpu_torch.runtime.executor import SlotExecutor
    from openairinterface5g_tpu_torch.utils import profiling
    x = torch.randn(2048, 2048, device=cuda)

    def busy(i, read=False):
        y = x
        for _ in range(8):
            y = y @ x / 2048
        return float(y.sum()) if read else y.sum()

    counts = []
    for read in (False, True):
        ex = SlotExecutor(lambda i: busy(i, read), depth=2, device=cuda)
        ex.run([()] * 2, collect=False)
        profiling.reset()
        profiling.enable()
        try:
            ex.run([()] * 10, collect=False)
        finally:
            profiling.disable()
        got = profiling.snapshot()["counts"]["runtime/executor.py:inflight"]
        counts.append([r.total for r in got])
    profiling.reset()
    assert counts[0][:2] == [0.0, 1.0] and counts[0][2:] == [2.0] * 8, counts[0]
    assert counts[1] == [0.0] * 10


def test_executor_defaults_to_the_card(cuda):
    from openairinterface5g_tpu_torch.runtime import executor
    ex = executor.SlotExecutor(lambda i: torch.ones(1, device="cuda") * i)
    assert ex.device.type == "cuda" and ex.stream is not None
    assert [float(r) for r in ex.run([()] * 3)] == [0.0, 1.0, 2.0]


def _one_rank(calls, device="cuda"):
    """launch.run_calls on a world of one rank (NCCL on card 0, or gloo);
    the kernels are built here first, so the rank only loads them."""
    from openairinterface5g_tpu_torch.ops import _cuda
    from openairinterface5g_tpu_torch.parallel import launch
    if device == "cuda":
        _cuda.build()
    return launch.spawn(launch.run_calls, 1, device, (calls,))[0]


def test_collectives_over_nccl_at_world_1(cuda):
    """The self pair's local copy, all_gather and all_to_all_single over NCCL
    with one rank, complex tensors as real views."""
    from openairinterface5g_tpu_torch.parallel import collectives as tc
    from openairinterface5g_tpu_torch.parallel.launch import MESH, Call
    g = torch.Generator().manual_seed(14)
    x = torch.complex(torch.randn(1, 4, 6, generator=g), torch.randn(1, 4, 6, generator=g))
    perm, gather, a2a, total = _one_rank([
        Call(tc.ppermute, (1,), ("sp",), (x, MESH, "sp", [(0, 0)])),
        Call(tc.all_gather, (1,), ("sp",), (x, MESH, "sp", 2, True)),
        Call(tc.all_to_all, (1,), ("sp",), (x, MESH, "sp", 1, 2, True)),
        Call(tc.psum, (1,), ("sp",), (torch.arange(5, dtype=torch.int32), MESH, "sp"))])
    assert torch.equal(perm, x) and torch.equal(gather, x) and torch.equal(a2a, x)
    assert torch.equal(total, torch.arange(5, dtype=torch.int32))


def test_sharded_ldpc_decode_flooding_matches_plain(cuda):
    """sharded_ldpc_decode's K1 flooding call on the card, bit-equal to the
    plain version: BG1 Z=384 x 26, AWGN at a level some blocks fail."""
    from openairinterface5g_tpu_torch.parallel import sharded
    from openairinterface5g_tpu_torch.parallel.launch import MESH, Call, Shard
    g = ldpc.build_graph(1, 384)
    rng = np.random.default_rng(14)
    info = torch.as_tensor(rng.integers(0, 2, (26, g.K)).astype(np.int8))
    cw = ldpc.encode(g, info).float()
    llr = (2.0 * ((1 - 2 * cw) + 0.85 * torch.as_tensor(rng.standard_normal(cw.shape),
                                                         dtype=torch.float32)) / 0.85 ** 2)
    llr[:, :2 * g.Z] = 0
    bits, ok = _one_rank([Call(sharded.sharded_ldpc_decode, (1,), ("dp",),
                               (MESH, g, Shard(llr)), {"n_iters": 6})])[0]
    want = ldpc_decoder.decode_plain(g, llr, 6, schedule="flooding")
    assert torch.equal(bits, want[0]) and torch.equal(ok, want[1])


def test_subcarrier_sharded_rx_at_273_prb_matches_cpu(cuda):
    """The sp receiver at the dry run's 273 PRB, 2 layers, on one card and on
    one CPU rank: the same bits, CRC and code-block flags; the sent TBs."""
    from openairinterface5g_tpu_torch.parallel import dryrun, pusch_sp
    from openairinterface5g_tpu_torch.parallel.launch import MESH, Call
    cfg = pusch.PuschConfig(**dryrun.SP_CFG)
    tb = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (2, cfg.tbs), dtype=np.int8))
    grid = dryrun._clean_grid(cfg, tb)
    call = [Call(pusch_sp.pusch_rx_subcarrier_sharded, (1,), ("sp",), (MESH, cfg, grid),
                 {"n_iters": dryrun.N_ITERS})]
    card, cpu = _one_rank(call)[0], _one_rank(call, "cpu")[0]
    for k in ("tb_bits", "tb_ok", "cb_ok"):
        assert torch.equal(card[k], cpu[k]), k
    assert bool(card["tb_ok"].all()) and torch.equal(card["tb_bits"], tb)


def test_eager_frontend_never_waits_on_the_card(cuda):
    """pusch_frontend at 4 layers (two CDM groups: K3 does not take it, so
    the eager estimate, the per-RE MMSE and the LLRs run) at 106 PRB: after
    one warm call, a second runs under set_sync_debug_mode("error"), so no
    operation of it waits for the card, and gives the warm call's LLRs."""
    cfg = pusch.PuschConfig(mu=1, n_prb=106, mcs=9, n_layers=4, n_rx=4)
    assert not fe.supported(cfg)
    y = _rx_grid(cfg, cuda, seed=21, B=2, noise=0.05)
    warm = pusch.pusch_frontend(cfg, y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        llr = pusch.pusch_frontend(cfg, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert llr.shape == (2, cfg.G) and bool(torch.isfinite(llr).all())
    assert torch.allclose(llr, warm, rtol=0, atol=1e-5 * float(warm.abs().max()))


def test_graphed_frontend_matches_the_eager_chain(cuda):
    """At 4 layers on the card, 'auto' replays the eager chain from CUDA
    graphs: its LLRs equal the chain run op by op ('reference'), a later
    call with other samples leaves an earlier call's LLRs as they were, and
    traced, each stage's span and the noise counter hold what the chain
    gives."""
    from openairinterface5g_tpu_torch.utils import profiling
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=9, n_layers=4, n_rx=4)
    eager = dataclasses.replace(cfg, frontend_backend="reference")
    assert pusch._use_graphed_frontend(cfg, torch.zeros(1, device=cuda))
    assert not pusch._use_graphed_frontend(eager, torch.zeros(1, device=cuda))
    y1 = _rx_grid(cfg, cuda, seed=31, B=2, noise=0.05)
    y2 = _rx_grid(cfg, cuda, seed=32, B=2, noise=0.05)
    first = pusch.pusch_frontend(cfg, y1)
    second = pusch.pusch_frontend(cfg, y2)
    torch.cuda.synchronize()
    for got, y in ((first, y1), (second, y2)):
        ref = pusch.pusch_frontend(eager, y)
        assert got.shape == ref.shape == (2, cfg.G)
        assert torch.allclose(got, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))
    assert any(k[0] == cfg for k in pusch._GRAPHS)
    profiling.reset()
    profiling.enable()
    try:
        pusch.pusch_frontend(cfg, y1)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    names = {s.name for s in snap["spans"]}
    assert {"phy/channel_estimation.py", "phy/equalization.py", "phy/llr.py"} <= names
    _, nvar = pusch.pusch_channel_estimate(cfg, y1)
    (got,) = snap["counts"]["phy/channel_estimation:nvar"]
    assert got.n == 2 and abs(got.total - float(nvar.sum())) <= 1e-6 * float(nvar.sum())
