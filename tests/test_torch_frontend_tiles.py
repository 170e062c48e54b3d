"""The design of K3's kernel (csrc/pusch_frontend.cu) on the CPU.

No kernel runs here.  The kernel is one launch of a thread-block cluster
per slot; each block owns one tile of subcarriers and estimates the channel
over it plus a halo from its own loads, one group of antennas at a time.
These tests hold:
  * the launch plan of ``ops/pusch_frontend.py`` (``tile_of``,
    ``cluster_sizes``, ``shape_of``; the kernel's ``tile_of`` and
    ``layout_of`` are the same plan in C): the tiles cover [0, M) once with
    edges on multiples of 4, the halo holds every pilot the moving average
    and the comb-2 interpolation read (replicate padding clamped at the
    allocation's edges), in whole CDM pairs, every 2-layer noise term is
    owned by exactly one tile, and shared memory fits any number of
    antennas and DMRS symbols by taking the antennas in groups;
  * a test-local PyTorch model of the tiled schedule (per tile and antenna
    group: the block's loads only, LS, CDM split, the share of nvar its
    pairs own, moving average, interpolation, the Gram matrix and the
    matched filter summed over the groups; nvar summed over the tiles in
    rank order; the MMSE; the packed scrambling signs) against
    ``frontend_planes_plain`` at 2e-4 of max|LLR|, the kernel's bar.
"""
import numpy as np
import pytest
import torch

from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
from openairinterface5g_tpu_torch.ops.pusch_frontend_cases import EDGE_CFGS, WIDE_CFGS
from openairinterface5g_tpu_torch.phy import llr as llr_mod
from openairinterface5g_tpu_torch.phy import refsig
from test_torch_cuda import FRONTEND_CFGS, _rx_grid

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TOL = 2e-4


def tiles(n_prb: int, window: int, C: int) -> list:
    return [fe.tile_of(t, C, 6 * n_prb, window) for t in range(C)]


def _pads(window):
    return (window // 2, window - 1 - window // 2) if window > 1 else (0, 0)


def _take(x, idx, lo, n):
    """x[..., idx - lo], refusing any index outside the n loaded entries
    (torch would wrap a negative one)."""
    i = torch.as_tensor(idx) - lo
    assert int(i.min()) >= 0 and int(i.max()) < n, (int(i.min()), int(i.max()), n)
    return x[..., i]


def _interp(hs, m, h_lo, delta, n_pil):
    """Comb-2 interpolation of hs (..., pilots h_lo...) at subcarriers m."""
    n = hs.shape[-1]
    on = (m - delta) % 2 == 0
    k = m // 2
    if delta == 0:
        a, b = k, torch.clamp(k + 1, max=n_pil - 1)
    else:
        a, b = torch.clamp(k - 1, min=0), k
    comb = _take(hs, torch.where(on, (m - delta) // 2, k), h_lo, n)
    mid = 0.5 * (_take(hs, a, h_lo, n) + _take(hs, b, h_lo, n))
    return torch.where(on, comb, mid)


def tiled_planes(cfg, y: torch.Tensor, C: int, r_grp: int = None) -> torch.Tensor:
    """The kernel's schedule in PyTorch: (B, qm, G/qm) planes from the RE grid
    y, tile by tile and antenna group by group, at cluster size C and r_grp
    antennas per group (the plan's where not given)."""
    B, R = y.shape[:2]
    P, qm, n_prb, a0, w = cfg.n_layers, cfg.qm_rate[0], cfg.n_prb, cfg.sc0, cfg.chest_window
    n_pil, M = 6 * n_prb, 12 * n_prb
    delta = refsig.dmrs_type1_port_weights(cfg.dmrs_port0 % 4)[1]
    dmrs, data = sorted(cfg.dmrs_symbols), list(cfg.data_symbols)
    S = len(data)
    if r_grp is None:
        r_grp = fe.shape_of(C, R, P, n_pil, len(dmrs), S, w).r_grp
    pil = torch.as_tensor(np.stack([cfg.dmrs_pilot_np(s) for s in dmrs]))
    pad_l, pad_r = _pads(w)
    parts, sums = [], []
    for t in tiles(n_prb, w, C):
        n_ls = t.hi - t.lo
        j = torch.arange(t.h_lo, t.h_hi + 1)
        q = (j[:, None] + torch.arange(-pad_l, pad_r + 1)).clamp(0, n_pil - 1)
        part = torch.zeros(B)
        gram = torch.zeros((B, 3, t.m1 - t.m0), dtype=torch.complex64)   # g00, g11, g01
        x = torch.zeros((B, P, S, t.m1 - t.m0), dtype=torch.complex64)
        for r0 in range(0, R, r_grp):
            ant = slice(r0, min(R, r0 + r_grp))
            rows = y[:, ant][:, :, dmrs, a0 + 2 * t.lo: a0 + 2 * t.hi]   # the group's DMRS loads
            ls = (rows[..., delta::2] * pil[:, t.lo:t.hi].conj()).sum(2) / len(dmrs)
            if P == 2:
                e, o = ls[..., 0::2], ls[..., 1::2]
                pr = torch.stack([0.5 * (e + o), 0.5 * (e - o)], 2)   # (B, rg, 2, n_ls / 2)
                g = t.lo // 2 + torch.arange(n_ls // 2)
                own = torch.nonzero((g >= t.m0 // 4) & (g < t.m1 // 4)
                                    & (g + 1 < n_pil // 2))[:, 0]
                d = (_take(pr, g[own] + 1, t.lo // 2, n_ls // 2)
                     - _take(pr, g[own], t.lo // 2, n_ls // 2))
                part = part + (d.abs() ** 2).sum((1, 2, 3))
                vals = _take(pr, q // 2, t.lo // 2, n_ls // 2)      # (B, rg, 2, n_hs, w')
            else:
                vals = _take(ls[:, :, None], q, t.lo, n_ls)
            hs = vals.sum(-1) / w if w > 1 else vals[..., 0]
            h = _interp(hs, torch.arange(t.m0, t.m1), t.h_lo, delta, n_pil)   # (B, rg, P, tile)
            gram[:, 0] += (h[:, :, 0].abs() ** 2).sum(1)
            if P == 2:
                gram[:, 1] += (h[:, :, 1].abs() ** 2).sum(1)
                gram[:, 2] += (h[:, :, 0].conj() * h[:, :, 1]).sum(1)
            yd = y[:, ant][:, :, data, a0 + t.m0: a0 + t.m1]         # (B, rg, S, tile)
            x += (yd[:, :, None] * h.conj()[:, :, :, None]).sum(1)   # matched filter
        parts.append(part)
        sums.append((t, gram, x))
    nvar = (sum(parts) * len(dmrs) / (R * P * (n_pil // 2 - 1))) if P == 2 else None

    planes = torch.empty((B, qm, S, M, P))
    bits = fe._signs(cfg, torch.device("cpu"))[:, None] >> torch.arange(P * qm, dtype=torch.int32)
    bits = (bits & 1).reshape(S, M, P, qm)
    for t, gram, x in sums:
        g00 = gram[:, 0].real
        if P == 1:
            e, mag = x, g00[:, None]                                 # MRC
        else:
            g11, g01 = gram[:, 1].real, gram[:, 2]
            a00, a11 = g00 + nvar[:, None], g11 + nvar[:, None]
            ag2 = g01.abs() ** 2
            inv = 1.0 / (a00 * a11 - ag2)
            c = lambda v: v[:, None]                                 # noqa: E731
            e = torch.stack([c(a11 * inv) * x[:, 0] - c(g01 * inv) * x[:, 1],
                             c(a00 * inv) * x[:, 1] - c(g01.conj() * inv) * x[:, 0]], 1)
            mag = torch.stack([(a11 * g00 - ag2) * inv, (a00 * g11 - ag2) * inv], 1)
        llr = llr_mod.llrs(e.reshape(B, P, -1), mag[:, :, None].expand(e.shape).reshape(B, P, -1),
                           qm).reshape(B, P, S, -1, qm)
        sg = 1.0 - 2.0 * bits[:, t.m0:t.m1].permute(2, 0, 1, 3).to(torch.float32)   # (P, S, tile, qm)
        planes[:, :, :, t.m0:t.m1, :] = (llr * sg).permute(0, 4, 2, 3, 1)
    return planes.reshape(B, qm, S * M * P)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_prb", [1, 2, 3, 6, 20, 24, 51, 273])
def test_cluster_sizes(n_prb):
    sizes = fe.cluster_sizes(n_prb)
    assert sizes[0] <= min(fe.MAX_CLUSTER, 3 * n_prb) < 2 * sizes[0]
    assert sizes == tuple(sizes[0] >> i for i in range(len(sizes))) and sizes[-1] == 1
    assert fe.cluster_sizes(273)[0] == 16 and fe.cluster_sizes(1) == (2, 1)


def test_planned_cluster():
    """The first size the plan tries: the fastest of every size in the
    sweep of tools/bench_frontend.py --clusters (2x2, B = 8, NVIDIA H100;
    PERF.md), no larger as the allocation narrows, tiles of MIN_TILE
    subcarriers and 16 blocks only at WIDE_TILE."""
    picks = {n: fe.planned_cluster(n) for n in range(1, 276)}
    assert {n: picks[n] for n in (6, 20, 51, 160, 273)} == {6: 2, 20: 8, 51: 8, 160: 16, 273: 16}
    assert picks[106] in (8, 16)                               # a tie there
    assert all(picks[n] <= picks[n + 1] for n in range(1, 275))
    for n, c in picks.items():
        assert c in fe.cluster_sizes(n)
        assert c == 1 or 12 * n // c >= (fe.WIDE_TILE if c == 16 else fe.MIN_TILE)


@pytest.mark.parametrize("n_prb", [1, 2, 3, 6, 20, 24, 51, 273])
@pytest.mark.parametrize("window", [0, 1, 2, 8, 16, 33])
def test_tile_plan(n_prb, window):
    n_pil, M = 6 * n_prb, 12 * n_prb
    pad_l, pad_r = _pads(window)
    for C in fe.cluster_sizes(n_prb):
        plan = tiles(n_prb, window, C)
        assert [t.m0 for t in plan[1:]] == [t.m1 for t in plan[:-1]]
        assert plan[0].m0 == 0 and plan[-1].m1 == M
        owned = []
        for t in plan:
            assert t.m0 % 4 == 0 and t.m1 > t.m0
            # every subcarrier's interpolation reads its comb pilots and the
            # neighbour, held at the allocation's edges
            need = {min(m // 2 + 1, n_pil - 1) if m % 2 else m // 2 for m in range(t.m0, t.m1)}
            need |= {max(m // 2 - 1, 0) if m % 2 == 0 else m // 2 for m in range(t.m0, t.m1)}
            assert t.h_lo == min(need) and t.h_hi == max(need)
            # the window over those pilots, clamped to the allocation, in pairs
            reads = {min(max(q, 0), n_pil - 1) for j in need
                     for q in range(j - pad_l, j + pad_r + 1)}
            assert t.lo <= min(reads) and max(reads) < t.hi <= n_pil
            assert t.lo % 2 == 0 and t.hi % 2 == 0
            assert t.lo >= min(reads) - 1 and t.hi <= max(reads) + 2
            # 2-layer noise terms: pair g and g + 1, owned where g is in the tile
            for g in range(t.m0 // 4, t.m1 // 4):
                if g + 1 < n_pil // 2:
                    assert t.lo <= 2 * g and 2 * g + 4 <= t.hi
                    owned.append(g)
        assert sorted(owned) == list(range(n_pil // 2 - 1))    # each term once


# --------------------------------------------------------------------------
# the model of the schedule against the plain version
# --------------------------------------------------------------------------

def _check(kw, C=None, seed=0, B=2, r_grp=None):
    cfg = pusch.PuschConfig(mu=1, **kw)
    assert fe.supported(cfg)
    y = _rx_grid(cfg, torch.device("cpu"), seed, B=B)
    ref = fe.frontend_planes_plain(cfg, y)
    for c in (fe.cluster_sizes(cfg.n_prb) if C is None else C):
        got = tiled_planes(cfg, y, c, r_grp)
        assert got.shape == ref.shape
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err < TOL, (c, err)


@pytest.mark.parametrize("kw", FRONTEND_CFGS + EDGE_CFGS)
def test_model_matches_plain(kw):
    """At the cluster size the plan tries first."""
    _check(kw, C=(fe.planned_cluster(kw["n_prb"]),), seed=len(str(kw)))


@pytest.mark.parametrize("kw", [dict(n_prb=3, mcs=16, n_layers=2, n_rx=2, chest_window=16),
                                dict(n_prb=24, mcs=16, n_layers=2, n_rx=2, dmrs_port0=2),
                                dict(n_prb=20, mcs=9, n_layers=1, n_rx=2)])
def test_model_at_every_cluster_size(kw):
    """At every size the kernel takes (the plan's fallbacks and the tools'
    sweep)."""
    _check(kw, seed=3)


def test_signs_pack_the_scrambling_sequence():
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=19, n_layers=2, n_rx=2)
    qm = cfg.qm_rate[0]
    c = fe._scrambling_bits(cfg, torch.device("cpu")).to(torch.int32).reshape(-1, 2 * qm)
    s = fe._signs(cfg, torch.device("cpu"))
    assert s.dtype == torch.int32 and s.shape == (cfg.G // (2 * qm),)
    for k in range(2 * qm):
        assert torch.equal((s >> k) & 1, c[:, k])


# --------------------------------------------------------------------------
# shared memory and antenna groups
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("n_dmrs", [1, 4])
@pytest.mark.parametrize("n_prb", [1, 24, 273])
def test_shape_fits_any_antenna_count(P, n_dmrs, n_prb):
    """Every antenna count finds a shape at the largest cluster size, within
    the budget; all antennas in one group where they fit, else the fewest
    groups that fit, the antennas spread evenly over them."""
    C, n_data = fe.cluster_sizes(n_prb)[0], 14 - n_dmrs
    for R in (1, 2, 3, 4, 8, 16, 17, 32, 64, 128):
        s = fe.shape_of(C, R, P, 6 * n_prb, n_dmrs, n_data, 16)
        assert s is not None and s.C == C and 1 <= s.s_buf <= n_data
        assert s.smem <= fe.SMEM_BUDGET
        assert s.smem == fe.smem_bytes(P, R, s.r_grp, s.s_buf, n_dmrs, n_data, s.tile_cap,
                                       s.ls_cap, s.hs_cap)
        n_grp = -(-R // s.r_grp)
        assert s.r_grp == -(-R // n_grp)                        # even groups
        if n_grp > 1:                                           # the fewest groups
            wider = -(-R // (n_grp - 1))
            assert (fe.smem_bytes(P, R, wider, 1, n_dmrs, n_data, s.tile_cap, s.ls_cap,
                                  s.hs_cap) > fe.SMEM_BUDGET)
    # the main path: both antennas, every data symbol in one round
    main = fe.shape_of(16, 2, 2, 6 * 273, 1, 13, 8)
    assert (main.r_grp, main.s_buf) == (2, 13)


@pytest.mark.parametrize("kw", WIDE_CFGS)
def test_wide_configurations_take_groups(kw):
    cfg = pusch.PuschConfig(mu=1, **kw)
    s = fe.shape_of(fe.cluster_sizes(cfg.n_prb)[0], cfg.n_rx, cfg.n_layers, 6 * cfg.n_prb,
                    len(cfg.dmrs_symbols), len(cfg.data_symbols), cfg.chest_window)
    assert s.C == 16 and s.smem <= fe.SMEM_BUDGET
    assert s.r_grp < cfg.n_rx or s.s_buf < len(cfg.data_symbols)


@pytest.mark.parametrize("kw,r_grp", [
    (dict(n_prb=24, mcs=16, n_layers=2, n_rx=4), 1),
    (dict(n_prb=24, mcs=16, n_layers=2, n_rx=4), 3),            # an uneven last group
    (dict(n_prb=6, mcs=16, n_layers=2, n_rx=5, dmrs_symbols=(2, 7, 11)), 2),
    (dict(n_prb=20, mcs=9, n_layers=1, n_rx=3), 2),
])
def test_model_in_antenna_groups(kw, r_grp):
    """The noise terms, the Gram matrix and the matched filter summed over
    antenna groups give the plain version's planes."""
    _check(kw, C=fe.cluster_sizes(kw["n_prb"])[:1], seed=5, r_grp=r_grp)
    _check(kw, C=(fe.planned_cluster(kw["n_prb"]),), seed=5, r_grp=r_grp)


def test_model_wide_at_the_planned_groups():
    """273 PRB, 16 RX, 2 layers, 4 DMRS symbols: the plan's two groups."""
    kw = WIDE_CFGS[0]
    _check(kw, C=(16,), seed=6, B=1)
