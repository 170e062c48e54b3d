"""K3: fused PUSCH frontend — CUDA kernel and its plain version.

Port of openairinterface5g_tpu/ops/pusch_frontend_pallas.py.  From the RE
grid (B, n_rx, symbols, n_sc_bwp) to descrambled LLR bit planes
(B, qm, G/qm) in the 38.212 e-domain order: plane j holds bit j of every
(RE, layer), flat position re*L + l, which rate recovery consumes as
slices.

``frontend_planes`` launches ``csrc/pusch_frontend.cu`` for a CUDA tensor
and runs ``frontend_planes_plain`` (the port's unfused chain:
channel estimation, equalization, LLRs, descrambling) for a CPU tensor.

The kernel is one launch of a thread-block cluster per slot: each block of
a cluster owns one tile of subcarriers, estimates the channel over its
tile plus a halo, and the blocks share the 2-layer noise variance over
distributed shared memory.  The launch's shape is planned here, once per
configuration and device (``tile_of``, ``shape_of``, ``cluster_sizes``,
``planned_cluster``, ``_plan``); tests/test_torch_frontend_tiles.py holds the plan and a
PyTorch model of the tiled schedule against ``frontend_planes_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..phy import llr as llr_mod
from ..phy import refsig
from ..phy.scrambling import gold_sequence, pusch_cinit
from . import _cuda

launches = 0          # kernel launches by ``frontend_planes`` (CUDA tensors only)

MAX_CLUSTER = 16      # blocks per cluster (csrc/pusch_frontend.cu kMaxCluster; 8 is portable)
SMEM_BUDGET = 200 * 1024   # dynamic shared memory one block may take, bytes
# The cluster size the plan starts from (``planned_cluster``): the largest
# with tiles of at least MIN_TILE subcarriers, and 16 blocks only with tiles
# of at least WIDE_TILE.  From the device ms of every size at 6-273 PRB
# (tools/bench_frontend.py --clusters; PERF.md): below these widths a
# larger cluster cost more than it spread the work.
MIN_TILE = 24
WIDE_TILE = 64


def supported(cfg) -> bool:
    """Configurations the kernel computes: CP-OFDM, rectangular allocation,
    single-symbol DMRS, window estimation, linear receiver, 1-2 layers on
    one CDM group (2 layers: the (+1,-1) OCC pair), Qm in {2,4,6,8}."""
    if (cfg.transform_precoding or cfg.uses_re_map or cfg.dmrs_max_len != 1
            or cfg.chest_mode != "window" or cfg.n_layers > 2
            or cfg.qm_rate[0] not in (2, 4, 6, 8) or cfg.receiver != "linear"):
        return False
    deltas = {refsig.dmrs_type1_port_weights(p % 4)[1]
              for p in range(cfg.dmrs_port0, cfg.dmrs_port0 + cfg.n_layers)}
    if len(deltas) != 1:
        return False
    return not (cfg.n_layers == 2 and cfg.dmrs_port0 % 2 != 0)


def _scrambling_bits(cfg, device: torch.device) -> torch.Tensor:
    """(G,) int8 scrambling sequence c(n) of the codeword, on the device."""
    return gold_sequence(pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id), cfg.G, device)


def _plane_layout(cfg, llr_lay: torch.Tensor) -> torch.Tensor:
    """(B, L, n_re, qm) per-layer LLRs -> descrambled (B, qm, n_re*L) planes."""
    B, L, n_re, qm = llr_lay.shape
    c = _scrambling_bits(cfg, llr_lay.device)
    sgn = (1.0 - 2.0 * c.to(torch.float32)).reshape(n_re, L, qm)
    planes = llr_lay.permute(0, 3, 2, 1) * sgn.permute(2, 0, 1)   # (B, qm, n_re, L)
    return planes.reshape(B, qm, n_re * L)


def frontend_planes_plain(cfg, re_grid: torch.Tensor) -> torch.Tensor:
    """The unfused chain in PyTorch, laid out as the kernel's planes."""
    from ..models import pusch
    B = re_grid.shape[0]
    L, qm = cfg.n_layers, cfg.qm_rate[0]
    h_est, nvar = pusch.pusch_channel_estimate(cfg, re_grid)
    x, mag = pusch.pusch_equalize(cfg, re_grid, h_est, nvar)
    llr_lay = llr_mod.llrs(x.reshape(B, L, -1), mag.reshape(B, L, -1), qm)
    return _plane_layout(cfg, llr_lay.reshape(B, L, -1, qm))


def check_args(grid: tuple, shape, dtype: torch.dtype, contiguous: bool) -> None:
    """Raise ValueError unless the kernel takes an RE grid of this shape,
    type and layout, for a configuration whose grid per slot is `grid`
    (n_rx, symbols, n_sc)."""
    if dtype is not torch.complex64 or len(shape) != 4 or shape[1:] != grid or not contiguous:
        raise ValueError(f"frontend_planes: need a contiguous complex64 grid (B, {grid[0]}, "
                         f"{grid[1]}, {grid[2]}), got {dtype} {tuple(shape)}, "
                         f"contiguous={contiguous}")


class Tile(NamedTuple):
    """One block's share of a slot (the kernel's ``Tile``): subcarriers
    [m0, m1) of the allocation, the pilots [h_lo, h_hi] whose smoothed
    estimate it interpolates from, and the pilots [lo, hi) it loads (whole
    CDM pairs)."""
    m0: int
    m1: int
    h_lo: int
    h_hi: int
    lo: int
    hi: int


def tile_of(t: int, C: int, n_pil: int, window: int) -> Tile:
    """Tile t of C over n_pil pilots (csrc/pusch_frontend.cu ``tile_of``):
    the CDM pairs [t n_q // C, (t + 1) n_q // C) of n_q = n_pil / 2, so its
    edges fall on multiples of 4 subcarriers.  The halo reaches pad_l + 1
    pilots left and pad_r + 1 right of the tile (the moving average and the
    interpolation neighbour), clamped to the allocation, rounded out to
    whole pairs."""
    n_q = n_pil // 2
    q0, q1 = t * n_q // C, (t + 1) * n_q // C
    pad_l = window // 2 if window > 1 else 0
    pad_r = window - 1 - window // 2 if window > 1 else 0
    h_lo, h_hi = max(0, 2 * q0 - 1), min(n_pil - 1, 2 * q1)
    return Tile(4 * q0, 4 * q1, h_lo, h_hi, max(0, h_lo - pad_l) & ~1,
                (min(n_pil - 1, h_hi + pad_r) | 1) + 1)


class Shape(NamedTuple):
    """A launch's shape: C blocks per cluster, r_grp antennas per group,
    s_buf data symbols staged per round, the widest tile's subcarriers,
    loaded and smoothed pilots, and the dynamic shared memory of a block."""
    C: int
    r_grp: int
    s_buf: int
    tile_cap: int
    ls_cap: int
    hs_cap: int
    smem: int


def smem_bytes(P: int, R: int, r_grp: int, s_buf: int, n_dmrs: int, n_data: int,
               tile_cap: int, ls_cap: int, hs_cap: int) -> int:
    """The kernel's dynamic shared memory (csrc/pusch_frontend.cu
    ``layout_of``): s_buf staged data rows of r_grp antennas and their
    signs, one group's DMRS rows, the pilots, LS, port split, smoothed and
    interpolated estimate, the matched filter's sums over the groups (more
    than one group), the gains and the 2-layer Gram/MMSE coefficients."""
    f2, cap = 8, tile_cap
    return (f2 * s_buf * r_grp * cap + 4 * s_buf * cap
            + f2 * r_grp * n_dmrs * 2 * ls_cap + f2 * n_dmrs * ls_cap
            + f2 * r_grp * ls_cap * (2 if P == 2 else 1) + f2 * r_grp * P * hs_cap
            + f2 * P * r_grp * cap + (f2 * n_data * P * cap if r_grp < R else 0)
            + 4 * P * cap + (16 * cap if P == 2 else 0))


def shape_of(C: int, R: int, P: int, n_pil: int, n_dmrs: int, n_data: int,
             window: int) -> Optional[Shape]:
    """The shape of a launch in clusters of C: the caps over the C tiles;
    the fewest antenna groups (one, where all R antennas fit) such that a
    group leaves room in SMEM_BUDGET for one staged data symbol, the
    antennas spread evenly over them; as many data symbols per round as
    then fit (all of them where they do).  None if not even one antenna
    per group fits."""
    tiles = [tile_of(t, C, n_pil, window) for t in range(C)]
    tile_cap = max(t.m1 - t.m0 for t in tiles)
    ls_cap = max(t.hi - t.lo for t in tiles)
    hs_cap = max(t.h_hi - t.h_lo + 1 for t in tiles)
    hs_cap += hs_cap & 1              # keeps the parts after it 16-byte aligned

    def fit(r_grp):                   # (data symbols per round, bytes) of r_grp antennas
        fixed = smem_bytes(P, R, r_grp, 0, n_dmrs, n_data, tile_cap, ls_cap, hs_cap)
        row = tile_cap * (8 * r_grp + 4)           # one data symbol's staging
        s_buf = min(n_data, (SMEM_BUDGET - fixed) // row)
        return s_buf, fixed + s_buf * row

    widest = next((r for r in range(R, 0, -1) if fit(r)[0] >= 1), 0)
    if not widest:
        return None
    r_grp = -(-R // -(-R // widest))   # R over the fewest groups, evenly
    s_buf, smem = fit(r_grp)
    return Shape(C, r_grp, s_buf, tile_cap, ls_cap, hs_cap, smem)


def cluster_sizes(n_prb: int) -> tuple:
    """The cluster sizes the kernel takes at n_prb, largest first: powers of
    two up to MAX_CLUSTER with at least one CDM pair (4 subcarriers) per
    tile."""
    c = 1
    while c * 2 <= min(MAX_CLUSTER, 3 * n_prb):
        c *= 2
    return tuple(c >> i for i in range(c.bit_length()))


def planned_cluster(n_prb: int) -> int:
    """The cluster size the plan tries first at n_prb: the largest of
    ``cluster_sizes`` whose tiles hold MIN_TILE subcarriers (WIDE_TILE at
    16 blocks), or 1."""
    M = 12 * n_prb
    return next((c for c in cluster_sizes(n_prb)
                 if M // c >= (WIDE_TILE if c > 8 else MIN_TILE)), 1)


class _Plan(NamedTuple):
    """What a launch needs of its configuration, computed once per
    configuration and device."""
    grid: tuple                  # (n_rx, symbols, n_sc) of the RE grid per slot
    planes_shape: tuple          # (qm, G // qm) per slot
    consts: tuple                # pilots, packed scrambling signs
    ptrs: tuple                  # their data pointers
    shape: Shape                 # the launch's shape
    ints: tuple                  # R, P, n_sym, n_sc, a0, n_prb, delta, n_dmrs, n_data, qm,
    #                              window, DMRS and data symbol masks, then the shape


def _signs(cfg, device: torch.device) -> torch.Tensor:
    """(n_data * M,) int32: per RE the scrambling bits of its L * qm LLRs,
    bit l * qm + j for bit j of layer l (codeword bit (re * L + l) * qm + j)."""
    k = cfg.n_layers * cfg.qm_rate[0]
    c = _scrambling_bits(cfg, device).to(torch.int32).reshape(-1, k)
    return (c << torch.arange(k, dtype=torch.int32, device=device)).sum(1, dtype=torch.int32)


def _mask(symbols) -> int:
    return sum(1 << s for s in symbols)


def _active_clusters(P: int, qm: int, shape: Shape, index: int) -> int:
    """Clusters of this shape the card holds resident at once (0: none)."""
    active = ctypes.c_int(0)
    rc = _cuda.route().pusch_frontend_clusters(P, qm, shape.C, shape.smem,
                                               ctypes.addressof(active), index, None)
    if rc:
        raise _cuda.error(rc, "pusch_frontend_clusters")
    return active.value


@functools.lru_cache(maxsize=16)
def _plan(cfg, device: torch.device, C: Optional[int] = None) -> _Plan:
    """The plan of `cfg` on `device`.  Its constants there are the pilots
    (n_dmrs, 6*n_prb) complex64 of the DMRS symbols in ascending order (the
    kernel finds the symbols from masks) and the packed scrambling signs;
    its shape is the first of ``cluster_sizes`` from ``planned_cluster``
    down (or C, where given) that ``shape_of`` fits and of which the card
    holds a cluster.  An
    unsupported configuration raises ValueError (on every call: lru_cache
    keeps no exception)."""
    if not supported(cfg):
        raise ValueError("frontend_planes: configuration not supported by the kernel")
    fp = cfg.fp
    P, qm = cfg.n_layers, cfg.qm_rate[0]
    dmrs = sorted(cfg.dmrs_symbols)
    n_data = len(cfg.data_symbols)
    index = -1 if device.index is None else device.index
    shape = None
    first = planned_cluster(cfg.n_prb)
    for c in ([c for c in cluster_sizes(cfg.n_prb) if c <= first] if C is None else [C]):
        s = shape_of(c, cfg.n_rx, P, 6 * cfg.n_prb, len(dmrs), n_data, cfg.chest_window)
        if s is not None and _active_clusters(P, qm, s, index) > 0:
            shape = s
            break
    if shape is None:
        raise ValueError(f"frontend_planes: no cluster of {C or first} blocks or fewer "
                         f"fits {cfg.n_rx} antennas at {cfg.n_prb} PRB on {device}")
    consts = (torch.as_tensor(np.stack([cfg.dmrs_pilot_np(s) for s in dmrs]), device=device),
              _signs(cfg, device))
    delta = refsig.dmrs_type1_port_weights(cfg.dmrs_port0 % 4)[1]
    ints = (cfg.n_rx, P, fp.symbols_per_slot, fp.n_sc, cfg.sc0, cfg.n_prb, delta,
            len(dmrs), n_data, qm, cfg.chest_window, _mask(dmrs), _mask(cfg.data_symbols),
            *shape)
    return _Plan((cfg.n_rx, fp.symbols_per_slot, fp.n_sc), (qm, cfg.G // qm), consts,
                 tuple(t.data_ptr() for t in consts), shape, ints)


def _launch(cfg, re_grid: torch.Tensor, C: Optional[int] = None) -> torch.Tensor:
    """The kernel on a CUDA RE grid, at the planned cluster size or at C
    (the tools time each size)."""
    dev = re_grid.device
    plan = _plan(cfg, dev, C)
    check_args(plan.grid, re_grid.shape, re_grid.dtype, re_grid.is_contiguous())
    ptr = re_grid.data_ptr()
    if ptr % 16:                    # the kernel's bulk copies read 16-byte aligned rows
        raise ValueError("frontend_planes: the RE grid must start on a 16-byte boundary")
    B, index = re_grid.shape[0], re_grid.get_device()
    planes = torch.empty((B, *plan.planes_shape), dtype=torch.float32, device=dev)
    r = _cuda.route()
    rc = r.pusch_frontend(ptr, *plan.ptrs, planes.data_ptr(), B, *plan.ints, index,
                          r.stream(index))
    if rc:
        raise _cuda.error(rc, "pusch_frontend")
    global launches
    launches += 1
    return planes


def frontend_planes(cfg, re_grid: torch.Tensor) -> torch.Tensor:
    """RE grid (B, n_rx, symbols, n_sc_bwp) complex64 -> descrambled LLR
    planes (B, qm, G//qm) f32."""
    if re_grid.is_cuda:
        return _launch(cfg, re_grid)
    if re_grid.device.type != "cpu":
        raise ValueError(f"frontend_planes: tensor on {re_grid.device}, not CUDA or CPU")
    return frontend_planes_plain(cfg, re_grid)


def frontend(cfg, re_grid: torch.Tensor) -> torch.Tensor:
    """Codeword-order LLRs (B, G) from the planes (for callers that want the
    codeword order; quantized when cfg.llr_quant_bits is set)."""
    planes = frontend_planes(cfg, re_grid)
    B, qm, n = planes.shape
    L = cfg.n_layers
    llr_cw = planes.reshape(B, qm, n // L, L).permute(0, 2, 3, 1).reshape(B, n * qm)
    if cfg.llr_quant_bits:
        llr_cw = llr_mod.quantize(llr_cw, bits=cfg.llr_quant_bits)
    return llr_cw
