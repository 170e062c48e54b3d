"""Subcarrier-block-sharded PUSCH RX (port of
openairinterface5g_tpu/parallel/pusch_sp.py; the C7 fronthaul-split analog).

The reference splits RU from L1 across hosts over IF4p5 fronthaul
(frequency-domain IQ per antenna, SURVEY.md C7).  Here the resource grid's
subcarrier dimension is sharded over the mesh's `sp` axis: each rank owns
a PRB block, runs channel estimation, equalization and LLRs on it,
exchanges a one-pilot halo with its neighbour (``ppermute``: the
overlap-save boundary; the CP makes symbol boundaries clean, so only the
frequency dimension needs a halo), then all-gathers the LLR blocks and
decodes its share of the code blocks.

1-layer MRC and 2-layer MMSE (CDM group 0's ports separate on pilot pairs
that never straddle a PRB block; the equalizer is per RE; the noise
variance is a ``pmean`` over the axis).  The frontend stays unfused plain
PyTorch, as JAX's runs no Pallas kernel here; the decode is K1 flooding
on the card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..coding import ldpc, rate_matching
from ..coding.crc import crc_ok
from ..coding.segmentation import desegment_tb
from ..models.pusch import PuschConfig, _mmse_over_syms
from ..phy import refsig
from ..phy.channel_estimation import ls_estimate
from ..phy.llr import llrs as llr_compute
from ..phy.scrambling import pusch_cinit, scramble_llrs
from .collectives import all_gather, pmean, ppermute
from .mesh import axis_index, axis_size
from .sharded import sharded_ldpc_decode


def _right_halo(x: torch.Tensor, mesh: DeviceMesh, axis, n_dev: int) -> torch.Tensor:
    """x's last dimension shifted left by one, the right neighbour's first
    value at the end; the last rank holds its own last value (it has no
    right neighbour: the wrap-around pair is sent and received, then
    overwritten, as JAX does)."""
    nxt = ppermute(x[..., :1], mesh, axis, [(i, (i - 1) % n_dev) for i in range(n_dev)])
    if axis_index(mesh, axis) == n_dev - 1:
        nxt = x[..., -1:]
    return torch.cat([x[..., 1:], nxt], dim=-1)


def _block_llrs(cfg: PuschConfig, mesh: DeviceMesh, axis, grid_blk: torch.Tensor,
                pil_blk: torch.Tensor) -> torch.Tensor:
    """This rank's (B, R, symbols, blk) subcarrier block -> (B, S, blk*L*qm)
    LLRs in codeword-local order."""
    n_dev = axis_size(mesh, axis)
    B = grid_blk.shape[0]
    qm, _ = cfg.qm_rate
    data_syms = list(cfg.data_symbols)
    yp = grid_blk[:, :, cfg.dmrs_symbols[0], ::2]          # comb-2 pilots (delta 0)
    ls = ls_estimate(yp, pil_blk)
    y = grid_blk[:, :, data_syms, :]
    if cfg.n_layers == 1:
        hp = ls
        # interpolate comb-2 within the block, the halo at the seam
        mid = 0.5 * (hp + _right_halo(hp, mesh, axis, n_dev))
        h = torch.stack([hp, mid], dim=-1).reshape(*hp.shape[:-1], 2 * hp.shape[-1])
        # MRC per data symbol
        x = torch.sum(torch.conj(h)[:, :, None, :] * y, dim=1)
        mag = torch.sum(h.abs() ** 2, dim=1)[:, None, :].expand(x.shape)
        return llr_compute(x, mag, qm)                       # (B, S, blk*qm)
    # 2 layers: CDM group 0's frequency OCC on block-local pilot pairs
    # (ports 0/1: wf = [+, +] / [+, -])
    even, odd = ls[..., 0::2], ls[..., 1::2]
    hc = torch.stack([0.5 * (even + odd), 0.5 * (even - odd)], dim=2)
    # noise variance from the pairs' differences, a pmean over the axis for
    # one MMSE regularizer on every rank
    dd = hc[..., 1:] - hc[..., :-1]
    nvar = pmean(torch.mean(dd.abs() ** 2, dim=(1, 2, 3)), mesh, axis)     # (B,)
    # pair centres -> per subcarrier, the right neighbour's halo at the seam
    mid = 0.5 * (hc + _right_halo(hc, mesh, axis, n_dev))
    h4 = torch.stack([hc, hc, mid, mid], dim=-1)
    h = h4.reshape(*hc.shape[:-1], 4 * hc.shape[-1])       # (B, R, 2, blk)
    x, mag = _mmse_over_syms(h, y, nvar)                    # (B, 2, S, blk)
    lv = llr_compute(x, mag, qm)                            # (B, 2, S, blk*qm)
    # codeword-local order per (symbol, subcarrier): layer-major qm groups
    lv = lv.reshape(B, 2, len(data_syms), -1, qm)
    return lv.permute(0, 2, 3, 1, 4).reshape(B, len(data_syms), -1)


def pusch_rx_subcarrier_sharded(mesh: DeviceMesh, cfg: PuschConfig, re_grid: torch.Tensor,
                                n_iters: int = 10, axis="sp") -> dict:
    """(B, n_rx, symbols, n_sc) replicated grid -> decoded TB, on every rank.

    Requires cfg.n_layers in (1, 2) and n_prb dividing over the axis.  Each
    rank takes its subcarrier block of the grid it is given (a deployment
    would produce each block on the rank that owns its fronthaul stream),
    gathers the LLRs, decodes its ceil(C / n) code blocks (C padded to a
    multiple of n, device-major, as JAX slices them) and gathers the bits.
    Returns, whole on every rank as JAX returns them replicated: tb_bits
    (B, TBS), tb_ok (B,), cb_ok (B, C), and llrs, the descrambled codeword
    LLRs (B, G).
    """
    if cfg.n_layers not in (1, 2):
        raise ValueError("sp path: MRC (1 layer) or MMSE (2 layers)")
    n_dev = axis_size(mesh, axis)
    if cfg.n_prb % n_dev:
        raise ValueError(f"{cfg.n_prb} PRB do not divide over {n_dev} ranks")
    idx = axis_index(mesh, axis)
    blk = 12 * cfg.n_prb // n_dev          # subcarriers per rank
    pblk = 6 * cfg.n_prb // n_dev          # pilots per rank
    B, dev = re_grid.shape[0], re_grid.device
    qm, _ = cfg.qm_rate
    p, crc_name = cfg.seg_params()
    g = ldpc.build_graph(p.bg, p.Z)
    cinit_d = refsig.dmrs_cinit(cfg.slot, cfg.dmrs_symbols[0], cfg.n_id)
    pil_full = refsig.dmrs_sequence(cinit_d, 6 * cfg.n_prb, dev)

    llr_blk = _block_llrs(cfg, mesh, axis, re_grid[..., idx * blk:(idx + 1) * blk],
                          pil_full[idx * pblk:(idx + 1) * pblk])      # (B, S, blk*L*qm)
    # the full-band LLRs, blocks in frequency order -> codeword order
    llr_cw = all_gather(llr_blk, mesh, axis, axis_dim=2).reshape(B, -1)
    llr_cw = scramble_llrs(llr_cw, pusch_cinit(cfg.rnti, 0, cfg.n_id))
    offs = np.concatenate([[0], np.cumsum(cfg.cb_e_sizes())])
    stacked = torch.stack(
        [rate_matching.rate_match_rx(
            g, rate_matching.deinterleave_rx(llr_cw[:, int(offs[j]):int(offs[j + 1])], qm),
            0, p.F) for j in range(p.C)], dim=1)                  # (B, C, N)
    # C padded to n * ceil(C / n); this rank decodes its chunk
    per_dev = -(-p.C // n_dev)
    pad = n_dev * per_dev - p.C
    if pad:
        stacked = torch.cat([stacked, stacked.new_zeros((B, pad, stacked.shape[-1]))], dim=1)
    mine = stacked[:, idx * per_dev:(idx + 1) * per_dev].reshape(B * per_dev, -1)
    bits, ok = sharded_ldpc_decode(mesh, g, mine, n_iters=n_iters, axis=axis)
    # (n, B, per_dev, ...) device-major == CB order; drop the padding
    bits = all_gather(bits.reshape(B, per_dev, -1), mesh, axis, axis_dim=1, tiled=True)[:, :p.C]
    ok = ok.reshape(n_dev, B, per_dev).permute(1, 0, 2).reshape(B, -1)[:, :p.C]
    tb = desegment_tb(bits, p)
    return {"tb_bits": tb[..., :-(24 if crc_name == "24A" else 16)],
            "tb_ok": crc_ok(tb, crc_name), "cb_ok": ok, "llrs": llr_cw}
