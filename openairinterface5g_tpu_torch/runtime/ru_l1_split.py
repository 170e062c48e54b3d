"""RU <-> L1 functional split over IF4p5-analog fronthaul (two processes).

Port of openairinterface5g_tpu/runtime/ru_l1_split.py.  The reference gNB
can split the RU (radio + per-symbol OFDM FEP) from the rest of L1 across
hosts, exchanging frequency-domain IQ over IF4p5
(executables/nr-ru.c:278-600, radio/ETHERNET/): SURVEY.md C7 as an actual
PROCESS boundary, not an intra-chip shard.

Here:
  RU process ("south"): owns the radio side: UE TX chain + channel +
    noise (the ulsim air segment), then nr_fep_full's role (CP removal +
    FFT + RE extraction), int16 block-floating-point quantization, and
    one IF4p5 UDP packet per (symbol, antenna) north to L1.  For DL it
    does nr_feptx_ofdm's role: receives the L1's freq-domain slot grid,
    IFFT+CP, loops it through the channel, FEPs it back north (so the
    DL TX path crosses the split too).
  L1 process ("north"): PUSCH channel estimation -> equalize -> LLR ->
    rate recovery -> LDPC decode -> CRC, batched over received slots;
    prints the ulsim-style BLER line and "PUSCH test OK" gate.

Both run their PHY in torch on `device` (the card unless told otherwise);
the grids cross the link as numpy complex64.  The TBs come from the JAX
run's numpy generators; the AWGN of trial n from a torch.Generator on the
device seeded with n (10000 + j for DL slot j), where the JAX run seeds
jax.random.PRNGKey the same way.  The link's UDP ports are arguments, with
the JAX run's fixed ports as defaults.

BLER parity: the 106-PRB MCS9 AWGN point at 5 dB (nr_ulsim.misc operating
point, autotest ulsim-misc1) must pass through the int16 fronthaul
quantization:

  python -m openairinterface5g_tpu_torch.runtime.ru_l1_split l1 &
  python -m openairinterface5g_tpu_torch.runtime.ru_l1_split ru
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..fronthaul.if4p5 import DL_FD, If4p5Link, UL_FD
from ..models.pdsch import PdschConfig
from ..models.pusch import PuschConfig, pusch_rx_grid, pusch_tx, pusch_tx_grid
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from ..sim import resolve_device
from ..sim.channel import add_noise
from . import endpoint_stream, to_numpy

N_PRB = 106
MCS = 9
SNR_DB = 5.0
N_TRIALS = 64
N_DL = 4                     # DL loopback slots (PDSCH through the split)
RU_PORT = 47201
L1_PORT = 47202


def _cfg():
    return PuschConfig(mu=1, n_prb=N_PRB, mcs=MCS, n_layers=1, n_rx=1)


def _air(fp, tx: torch.Tensor, snr_db: float, seed: int) -> np.ndarray:
    """AWGN at snr_db over the occupied band, then the FEP: (B, n_ant,
    samples) -> (B, n_ant, symbols, n_sc) complex64 on the host."""
    sig = torch.mean(torch.abs(tx) ** 2)
    sigma2 = sig * (fp.fft_size / fp.n_sc) * 10 ** (-snr_db / 10)
    gen = torch.Generator(device=tx.device)
    gen.manual_seed(seed)
    rx = add_noise(gen, tx, sigma2)
    return to_numpy(extract_from_grid(fp, ofdm_demodulate(fp, rx, 0)))


def run_ru(n_trials: int = N_TRIALS, snr_db: float = SNR_DB, log=print,
           ru_port: int = RU_PORT, l1_port: int = L1_PORT,
           device: str | torch.device = "cuda"):
    """Radio + FEP process (south side of the split)."""
    tdev = resolve_device(str(device))
    cfg = _cfg()
    fp = cfg.fp
    # long timeout: the L1 batches its UL decodes before starting the DL
    # phase, so the RU may wait minutes for the first DL grid
    link = If4p5Link(ru_port, ("127.0.0.1", l1_port), timeout_s=600.0)
    rng = np.random.default_rng(7)
    try:
        with endpoint_stream(tdev):
            for trial in range(n_trials):
                tb = torch.as_tensor(rng.integers(0, 2, (1, cfg.tbs)).astype(np.int8), device=tdev)
                tx, _ = pusch_tx(cfg, tb)
                g = _air(fp, tx, snr_db, trial)
                link.send_grid(UL_FD, trial >> 8, trial & 0xFF, g[0])
                link.wait_ack()
                if trial % 16 == 0:
                    log(f"[ru] UL slot {trial}/{n_trials} sent north")
            # DL direction: L1 sends freq-domain PDSCH grids; RU runs
            # nr_feptx_ofdm's role + air + FEP, returns them north
            for j in range(N_DL):
                typ, frame, slot, gre = link.recv_grid(1, fp.symbols_per_slot,
                                                       fp.n_sc)
                assert typ == DL_FD
                tx = ofdm_modulate(fp, map_to_grid(fp, torch.as_tensor(gre, device=tdev)), 0)
                out = _air(fp, tx, snr_db, 10_000 + j)
                link.send_grid(UL_FD, frame, slot, out)
                link.wait_ack()
            log("[ru] done")
    finally:
        link.close()


def run_l1(n_trials: int = N_TRIALS, log=print, ru_port: int = RU_PORT,
           l1_port: int = L1_PORT, device: str | torch.device = "cuda") -> bool:
    """L1 process (north side): decode + BLER gate."""
    tdev = resolve_device(str(device))
    cfg = _cfg()
    fp = cfg.fp
    link = If4p5Link(l1_port, ("127.0.0.1", ru_port), timeout_s=300.0)
    grids = []
    try:
        with endpoint_stream(tdev):
            for _ in range(n_trials):
                typ, frame, slot, g = link.recv_grid(cfg.n_rx,
                                                     fp.symbols_per_slot, fp.n_sc)
                assert typ == UL_FD
                link.send_ack(frame, slot)
                grids.append(g)
            n_ok = 0
            bs = 16
            for i in range(0, n_trials, bs):
                batch = torch.as_tensor(np.stack(grids[i: i + bs]), device=tdev)
                ok = pusch_rx_grid(cfg, batch, n_iters=12)["tb_ok"]
                n_ok += int(ok.sum())
                log(f"[l1] decoded {i + batch.shape[0]}/{n_trials}: ok so far {n_ok}")
            bler = 1 - n_ok / n_trials
            log(f"[l1] UL through IF4p5 split: BLER {bler:.6f} "
                f"({n_ok}/{n_trials})")
            ul_pass = bler == 0.0

            # DL direction: compose PDSCH freq grids, send south, decode what
            # the RU loops back over the air
            dl = PdschConfig(mu=1, n_prb=N_PRB, mcs=MCS, n_layers=1, n_rx=1)
            rng = np.random.default_rng(11)
            dl_ok = 0
            for j in range(N_DL):
                tb = torch.as_tensor(rng.integers(0, 2, (1, dl.tbs)).astype(np.int8), device=tdev)
                gre, _ = pusch_tx_grid(dl, tb)
                link.send_grid(DL_FD, 0xFF, j, to_numpy(gre[0]))
                typ, frame, slot, g = link.recv_grid(1, fp.symbols_per_slot,
                                                     fp.n_sc)
                link.send_ack(frame, slot)
                out = pusch_rx_grid(dl, torch.as_tensor(g[None], device=tdev), n_iters=12)
                dl_ok += int(out["tb_ok"][0])
            log(f"[l1] DL through IF4p5 split: {dl_ok}/{N_DL} ok")
            passed = ul_pass and dl_ok == N_DL
            log("PUSCH test OK" if passed else "PUSCH test NOK")
            return passed
    finally:
        link.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description="RU/L1 IF4p5 split")
    ap.add_argument("role", choices=["ru", "l1"])
    ap.add_argument("-n", "--n-trials", type=int, default=N_TRIALS)
    ap.add_argument("-s", "--snr", type=float, default=SNR_DB)
    ap.add_argument("--ru-port", type=int, default=RU_PORT)
    ap.add_argument("--l1-port", type=int, default=L1_PORT)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.role == "ru":
        run_ru(args.n_trials, args.snr, ru_port=args.ru_port, l1_port=args.l1_port,
               device=args.device)
        return 0
    return 0 if run_l1(args.n_trials, ru_port=args.ru_port, l1_port=args.l1_port,
                       device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
