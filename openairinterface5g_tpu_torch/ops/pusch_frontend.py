"""K3: fused PUSCH frontend — CUDA kernel and its plain version.

Port of openairinterface5g_tpu/ops/pusch_frontend_pallas.py.  From the RE
grid (B, n_rx, symbols, n_sc_bwp) to descrambled LLR bit planes
(B, qm, G/qm) in the 38.212 e-domain order: plane j holds bit j of every
(RE, layer), flat position re*L + l, which rate recovery consumes as
slices.

``frontend_planes`` launches ``csrc/pusch_frontend.cu`` for a CUDA tensor
and runs ``frontend_planes_plain`` (the port's unfused chain:
channel estimation, equalization, LLRs, descrambling) for a CPU tensor.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..phy import llr as llr_mod
from ..phy import refsig
from ..phy.scrambling import gold_sequence, pusch_cinit
from . import _cuda

launches = 0          # kernel launches by ``frontend_planes`` (CUDA tensors only)


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


class _Plan(NamedTuple):
    """What a launch needs of its configuration, computed once per
    configuration and device."""
    grid: tuple                  # (n_rx, symbols, n_sc) of the RE grid per slot
    h_shape: tuple               # (R, P, M) channel-estimate scratch per slot
    planes_shape: tuple          # (qm, G // qm) per slot
    consts: tuple                # pilots, DMRS and data symbols, scrambling bits
    ptrs: tuple                  # their data pointers
    ints: tuple                  # R, P, n_sym, n_sc, a0, n_prb, delta, n_dmrs, n_data, qm, window


@functools.lru_cache(maxsize=16)
def _plan(cfg, device: torch.device) -> _Plan:
    """The plan of `cfg` on `device`; its constants there are the pilots
    (n_dmrs, 6*n_prb) complex64, the DMRS and data symbol indices, and the
    scrambling sequence as uint8.  An unsupported configuration raises
    ValueError (on every call: lru_cache keeps no exception)."""
    if not supported(cfg):
        raise ValueError("frontend_planes: configuration not supported by the kernel")
    fp = cfg.fp
    P, qm = cfg.n_layers, cfg.qm_rate[0]
    pil = np.stack([cfg.dmrs_pilot_np(s) for s in cfg.dmrs_symbols])
    consts = (torch.as_tensor(pil, device=device),
              torch.as_tensor(np.asarray(cfg.dmrs_symbols, np.int32), device=device),
              torch.as_tensor(np.asarray(cfg.data_symbols, np.int32), device=device),
              _scrambling_bits(cfg, device).view(torch.uint8))
    delta = refsig.dmrs_type1_port_weights(cfg.dmrs_port0 % 4)[1]
    ints = (cfg.n_rx, P, fp.symbols_per_slot, fp.n_sc, cfg.sc0, cfg.n_prb, delta,
            len(cfg.dmrs_symbols), len(cfg.data_symbols), qm, cfg.chest_window)
    return _Plan((cfg.n_rx, fp.symbols_per_slot, fp.n_sc), (cfg.n_rx, P, 12 * cfg.n_prb),
                 (qm, cfg.G // qm), consts, tuple(t.data_ptr() for t in consts), ints)


def _launch(cfg, re_grid: torch.Tensor) -> torch.Tensor:
    dev = re_grid.device
    plan = _plan(cfg, dev)
    check_args(plan.grid, re_grid.shape, re_grid.dtype, re_grid.is_contiguous())
    B, index = re_grid.shape[0], re_grid.get_device()
    h = torch.empty((B, *plan.h_shape), dtype=torch.complex64, device=dev)
    nvar = torch.empty((B,), dtype=torch.float32, device=dev)
    planes = torch.empty((B, *plan.planes_shape), dtype=torch.float32, device=dev)
    r = _cuda.route()
    rc = r.pusch_frontend(re_grid.data_ptr(), *plan.ptrs, h.data_ptr(), nvar.data_ptr(),
                          planes.data_ptr(), B, *plan.ints, index, r.stream(index))
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
