"""Sharded slot processing (port of openairinterface5g_tpu/parallel/sharded.py).

Maps the reference's process-level parallelism onto mesh axes:
  - C2 (per-CB decode jobs)  -> code blocks sharded over an axis, decoded
    independently, the CRC flags all-gathered;
  - C4/C6 (symbol jobs, slot pipeline) -> slots sharded over `dp`.

SPMD: every rank of the mesh calls each function with its own shard, where
JAX's single controller passes the sharded global array.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..coding.ldpc import LDPCGraph
from ..models.pusch import pusch_rx, pusch_tx
from ..ops import ldpc_decoder
from ..sim.channel import add_noise
from .collectives import all_gather, psum


def sharded_ldpc_decode(mesh: DeviceMesh, graph: LDPCGraph, llr_local: torch.Tensor,
                        n_iters: int = 12, axis="dp"):
    """Decode this rank's (n_cb_local, N) LLRs -> (bits (n_cb_local, K) int8,
    ok (n_cb,) bool).

    The schedule of JAX's: flooding min-sum, alpha 0.8125, all `n_iters`
    iterations (K1 flooding on a CUDA tensor, its plain version on the
    CPU), with no traffic between ranks during the iterations.  The bits
    stay local, as JAX shards them; the ok flags are all-gathered in axis
    order, so every rank sees the TB-level verdict (the nr_postDecode
    aggregation analog).
    """
    bits, ok = ldpc_decoder.decode(graph, llr_local, n_iters=n_iters, schedule="flooding",
                                   check_every=0)
    return bits, all_gather(ok, mesh, axis, tiled=True)


def sharded_slot_sweep(mesh: DeviceMesh, cfg, snr_db: float, tb_local: torch.Tensor,
                       gen: torch.Generator, n_iters: int = 12, axis="dp"):
    """The PUSCH TX -> AWGN -> RX chain on this rank's trials ->
    (ok (B_local,) local CRC flags, total: the success count psum'd over
    the axis, on every rank).

    The noise is scaled as JAX's (this rank's mean signal power per layer,
    the FFT's oversampling, `snr_db`) and drawn from this rank's `gen`
    where JAX splits a key per device: the draws differ from JAX's, the
    function does not.  The receiver is ``pusch_rx``: K3 on the card, and
    K1 layered where ``cfg.decoder_backend == "kernel"``.
    """
    tx, _ = pusch_tx(cfg, tb_local)
    sig = torch.mean(torch.sum(tx.abs() ** 2, dim=-2)) / cfg.n_layers
    sigma2 = sig * (cfg.fp.fft_size / cfg.fp.n_sc) * 10 ** (-snr_db / 10)
    rx = add_noise(gen, tx, sigma2)
    ok = pusch_rx(cfg, rx, n_iters=n_iters)["tb_ok"]
    return ok, psum(ok.sum(dtype=torch.int32), mesh, axis)
