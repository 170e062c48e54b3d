"""The entry point and the multi-device dry run (port of
``__graft_entry__.py::entry`` and ``dryrun_multichip``).

``dryrun_multichip`` shards the PUSCH TX -> channel -> RX step over the
group at the flagship configuration (273 PRB, 2x2), in three phases:
  dp    — data-parallel trials, two chained HARQ rounds (rv 0, then rv 2
          combined into round 0's buffers): pusch_rx, so K3 and K1 layered
          on the card; the CRC successes psum'd
  sp    — subcarrier-block sharding (pusch_sp.py): the pilot halo by
          ppermute, the noise floor by pmean, the LLRs all-gathered, the
          code blocks decoded where they fall (K1 flooding); on the largest
          n_sp <= min(world, 7) that divides the PRBs (273 = 7 x 39)
  dpxcb — a (dp, cb) mesh: the frontend sharded over dp (K3 on the card)
          with the fused rate recovery, an all_to_all reshard onto the code
          blocks over both axes, the decode sharded there (K1 flooding),
          cb_ok gathered

SPMD: every rank of an initialized group calls ``dryrun_multichip``
(``launch.spawn(dryrun_multichip, world)``, or torchrun with ``main``);
rank 0 prints JAX's lines with the port's numbers.  The configurations are
JAX's; the TBs are random bits from `seed` (JAX's are zeros), the noise
comes from a generator per rank, and the dp phase decodes with the main
path's kernel (``decoder_backend="kernel"``) where JAX's configuration
took its XLA decoder.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..coding import ldpc, rate_matching
from ..models.pusch import PuschConfig, pusch_frontend, pusch_rx, pusch_tx
from ..phy.ofdm import extract_from_grid, ofdm_demodulate
from ..sim.channel import ChannelModel, add_noise, apply_channel
from . import launch
from .collectives import all_to_all, psum
from .mesh import axis_index, make_mesh, make_mesh_2d, shard_batch
from .multihost import init_multihost, rank_device
from .pusch_sp import pusch_rx_subcarrier_sharded
from .sharded import sharded_ldpc_decode

DP_CFG = dict(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2, decoder_backend="kernel")
SP_CFG = dict(mu=1, n_prb=273, mcs=9, n_layers=2, n_rx=2)
DPCB_CFG = dict(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2)
DP_SNR_DB = 18.0          # the AWGN's noise power, 10^(-18/10), as JAX's
N_ITERS = 4               # LDPC iterations of every phase
SP_TBS = 2                # TBs of the sp phase
SP_MAX = 7                # the sp mesh's largest size (273 = 7 x 39)


def entry(device: str = "cuda"):
    """The flagship model's forward step (the PUSCH gNB RX chain) at a
    40 MHz-class 2x2 configuration: (fn, example_args), where fn takes a
    batch of received complex64 IQ slots (B, n_rx, samples) on `device`
    and returns (decoded TB bits, CRC flags)."""
    cfg = PuschConfig(mu=1, n_prb=24, mcs=9, n_layers=2, n_rx=2)

    def fn(rx):
        out = pusch_rx(cfg, rx, n_iters=8)
        return out["tb_bits"], out["tb_ok"]

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: entry() runs on the card (device='cpu' to ask "
                           "for the CPU)")
    n_samples = cfg.fp.samples_per_slot(cfg.slot)
    return fn, (torch.zeros((2, cfg.n_rx, n_samples), dtype=torch.complex64, device=dev),)


def _tbs(cfg: PuschConfig, n: int, seed: int, dev: torch.device) -> torch.Tensor:
    """(n, TBS) random payload bits, the same on every rank."""
    bits = np.random.default_rng(seed).integers(0, 2, (n, cfg.tbs), dtype=np.int8)
    return torch.as_tensor(bits, device=dev)


def _clean_grid(cfg: PuschConfig, tb: torch.Tensor) -> torch.Tensor:
    """The RE grid of pusch_tx's slot with the layers as antennas, no noise."""
    tx, _ = pusch_tx(cfg, tb)
    return extract_from_grid(cfg.fp, ofdm_demodulate(cfg.fp, tx, 0))


def dp_phase(cfg: PuschConfig, seed: int = 0, n_iters: int = N_ITERS,
             snr_db: float = DP_SNR_DB) -> dict:
    """One trial per rank, two HARQ rounds over AWGN: tb_sent and tb_bits
    (1, TBS), tb_ok (1,) (either round), n_ok (the psum), line."""
    world, dev = dist.get_world_size(), rank_device()
    mesh = make_mesh(world, "dp")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1 + dist.get_rank())
    tb = shard_batch(mesh, _tbs(cfg, world, seed, dev), "dp")
    model = ChannelModel("AWGN", cfg.n_layers, cfg.n_rx, cfg.fp.sample_rate)
    sigma2 = 10 ** (-snr_db / 10)
    outs, harq = [], None
    for rv in (0, 2):
        tx, _ = pusch_tx(cfg, tb, rv=rv)
        rx = add_noise(gen, apply_channel(model, gen, tx)[0], sigma2)
        outs.append(pusch_rx(cfg, rx, rv=rv, n_iters=n_iters, harq_buffers=harq))
        harq = outs[-1]["harq_buffers"]
    ok = outs[0]["tb_ok"] | outs[1]["tb_ok"]
    n_ok = int(psum(ok.sum(dtype=torch.int32), mesh, "dp"))
    return {"tb_sent": tb, "tb_bits": outs[1]["tb_bits"], "tb_ok": ok, "n_ok": n_ok,
            "line": f"dryrun_multichip dp: {world} devices OK ({cfg.n_prb} PRB "
                    f"{cfg.n_layers}x{cfg.n_rx}, 2 HARQ rounds), tb_ok={n_ok}/{world}"}


def sp_phase(cfg: PuschConfig, seed: int = 0, n_iters: int = N_ITERS) -> dict | None:
    """SP_TBS noise-free TBs through pusch_rx_subcarrier_sharded on the
    first n_sp ranks: tb_sent, the receiver's dict, n_sp, line; None on a
    rank outside the sp mesh."""
    n_sp = min(dist.get_world_size(), SP_MAX)
    while cfg.n_prb % n_sp:
        n_sp -= 1
    mesh = make_mesh(n_sp, "sp")           # every rank builds it
    if mesh.get_coordinate() is None:
        return None
    tb = _tbs(cfg, SP_TBS, seed + 2, rank_device())
    out = pusch_rx_subcarrier_sharded(mesh, cfg, _clean_grid(cfg, tb), n_iters=n_iters)
    ok_sp = int(out["tb_ok"].sum())
    return {"tb_sent": tb, **out, "n_sp": n_sp,
            "line": f"dryrun_multichip sp: {n_sp}-way subcarrier sharding OK "
                    f"({cfg.n_prb} PRB, {cfg.n_layers}-layer "
                    f"{'MMSE' if cfg.n_layers == 2 else 'MRC'}), tb_ok={ok_sp}/{SP_TBS}"}


def _reshard(mesh, rows: torch.Tensor) -> torch.Tensor:
    """The dp row's code-block rows (cb * n, N), the same on every rank of
    the row (JAX's P("dp") replicates them over cb) -> this rank's n rows
    of P(("dp", "cb")), by one all_to_all over cb: chunk j of the rows
    goes to rank j of the row, in cb parts, part i from rank i, so each
    value crosses once."""
    cb = mesh.shape[1]
    chunk = rows.numel() // cb
    if rows.numel() % cb or chunk % cb:
        raise ValueError(f"{tuple(rows.shape)} rows do not split over {cb} ranks")
    parts = rows.reshape(cb, cb, chunk // cb)[:, axis_index(mesh, "cb")]   # (dest, part)
    got = all_to_all(parts, mesh, "cb", split_axis=0, concat_axis=0)       # (src, part)
    return got.reshape(rows.shape[0] // cb, rows.shape[1])


def dpcb_phase(cfg: PuschConfig, seed: int = 0, n_iters: int = N_ITERS) -> dict:
    """One trial per rank on a (2, world/2) mesh (world >= 4 and even, as
    JAX's) or (1, world): llr (C, N) and bits (C, K) of this rank's code
    blocks, cb_ok (world * C,) gathered, tb_sent of its dp row, line."""
    world, dev = dist.get_world_size(), rank_device()
    dp, cb = (2, world // 2) if world >= 4 and world % 2 == 0 else (1, world)
    mesh = make_mesh_2d(dp, cb)
    p, _ = cfg.seg_params()
    g = ldpc.build_graph(p.bg, p.Z)
    tb = shard_batch(mesh, _tbs(cfg, world, seed + 3, dev), "dp")     # (cb, TBS)
    llr = pusch_frontend(cfg, _clean_grid(cfg, tb))
    stacked = rate_matching.fused_rate_match_rx(g, llr, 0, tuple(cfg.cb_e_sizes()),
                                                cfg.qm_rate[0], p.F)  # (cb, C, N)
    mine = _reshard(mesh, stacked.reshape(cb * p.C, -1))
    bits, cb_ok = sharded_ldpc_decode(mesh, g, mine, n_iters=n_iters, axis=("dp", "cb"))
    n_ok, n_cb = int(cb_ok.sum()), world * p.C
    return {"tb_sent": tb, "llr": mine, "bits": bits, "cb_ok": cb_ok,
            "line": f"dryrun_multichip dp x cb: {dp}x{cb} mesh OK ({cfg.n_prb} PRB "
                    f"{cfg.n_layers}x{cfg.n_rx}, {n_cb} CBs), cb_ok={n_ok}/{n_cb}"}


PHASES = {"dp": (dp_phase, DP_CFG), "sp": (sp_phase, SP_CFG), "dpcb": (dpcb_phase, DPCB_CFG)}


def run_phase(name: str, cfg: dict | None = None, seed: int = 0) -> dict:
    """One phase of the dry run on this rank, timed by the host clock up
    to a synchronize of the rank's card; rank 0 prints its line."""
    fn, default = PHASES[name]
    t0 = time.perf_counter()
    out = fn(PuschConfig(**(default if cfg is None else cfg)), seed)
    if torch.cuda.is_available() and rank_device().type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if out is not None and dist.get_rank() == 0:
        print(out["line"], flush=True)
    return {"seconds": seconds, "out": out}


def dryrun_multichip(n_devices: int | None = None, cfgs: dict | None = None,
                     seed: int = 0) -> dict:
    """The three phases on this rank (an initialized group of `n_devices`
    ranks, default its size), each at JAX's configuration unless `cfgs`
    maps its name to PuschConfig fields: per phase its run_phase dict."""
    if n_devices not in (None, dist.get_world_size()):
        raise ValueError(f"n_devices {n_devices}: the group has {dist.get_world_size()} ranks")
    return {name: run_phase(name, (cfgs or {}).get(name), seed) for name in PHASES}


def main(argv=None) -> None:
    """``python -m openairinterface5g_tpu_torch.parallel.dryrun [--world N]``
    starts the ranks itself; under torchrun each process joins the group
    from torchrun's environment instead."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to start (default: one per card); ignored under torchrun")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        init_multihost(device=args.device)
        try:
            dryrun_multichip()
        finally:
            dist.destroy_process_group()
        return
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 1)
    launch.spawn(dryrun_multichip, world, args.device)


if __name__ == "__main__":
    main()
