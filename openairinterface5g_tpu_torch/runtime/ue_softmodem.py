"""nr-uesoftmodem-style UE bring-up loop (SURVEY.md §3.5).

Port of openairinterface5g_tpu/runtime/ue_softmodem.py.  Mirrors
executables/nr-ue.c `UE_thread`: the synchronization state machine
(initial sync: PSS time correlation -> SSS identify -> PBCH polar decode ->
MIB) followed by the steady connected loop (pbch_pdcch_processing /
pdsch_processing: DCI blind decode + PDSCH RX per slot).  In phytest mode
the matching gNB DL frames are generated in-process through AWGN; with
--iqfile the sync stage replays a recording captured with radio/iqplayer.

Every random draw (the SSB's position, the noise, the TBs) comes from
np.random.default_rng(1) in the JAX loop's order, so the port's inputs
equal the JAX loop's.

Usage: python -m openairinterface5g_tpu_torch.runtime.ue_softmodem -n 8
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import make_frame_params
from ..fapi.ue_if import DlConfigRequest, DlDciSearch, UePhy
from ..models.pbch import Mib, PbchConfig, mib_payload, mib_unpack, ssb_generate, ssb_receive
from ..models.pdcch import DciConfig, pdcch_tx_grid
from ..models.pdsch import PdschConfig
from ..models.pusch import pusch_tx_grid
from ..models.sync import initial_sync, ssb_time_signal
from ..models.ue import DCI_A, encode_grant
from ..phy import refsig as _rs
from ..sim import resolve_device


def mib_line(mib: dict) -> str:
    """The [mib] line's dict with each field as a number."""
    return str({k: int(v) for k, v in mib.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description="UE softmodem loop (phytest)")
    ap.add_argument("-n", "--n-slots", type=int, default=8)
    ap.add_argument("-m", "--mcs", type=int, default=9)
    ap.add_argument("-R", "--n-prb", type=int, default=48)
    ap.add_argument("-s", "--snr-db", type=float, default=20.0)
    ap.add_argument("--cell-id", type=int, default=17)
    ap.add_argument("--iqfile", type=str, default="",
                    help="replay the sync stage from an IQ recording")
    ap.add_argument("--cfo", type=float, default=0.0,
                    help="residual carrier offset (Hz) applied to the DL; "
                         "the connected loop tracks and derotates it "
                         "(nr_adjust_synch_ue / freq-offset loop analog)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    fp = make_frame_params(1, args.n_prb)
    rng = np.random.default_rng(1)
    noise_amp = 10 ** (-args.snr_db / 20)

    # ---- 1. initial sync: PSS timing -> SSS cell id -> PBCH/MIB ----------
    pcfg = PbchConfig(n_id=args.cell_id)
    mib = Mib()
    payload = torch.as_tensor(mib_payload(mib, sfn=0), device=dev)
    tile = ssb_generate(pcfg, payload[None])            # (1, 4, 240)
    if args.iqfile:
        from ..radio.iqplayer import IQPlayerDevice
        iq = IQPlayerDevice(args.iqfile, n_ant=1, mode="replay")
        stream = iq.read(0, 2 * fp.samples_per_slot(0))[0][None]
    else:
        ssb_t = ssb_time_signal(fp, tile)[0].cpu().numpy()
        pad = int(rng.integers(100, 900))
        sig = np.zeros(2 * fp.samples_per_slot(0), np.complex64)
        sig[pad: pad + len(ssb_t)] = ssb_t
        sig += (noise_amp / np.sqrt(2) * (
            rng.normal(size=sig.shape) + 1j * rng.normal(size=sig.shape))
        ).astype(np.complex64)
        stream = sig[None]

    t_start = time.time()
    res = initial_sync(fp, torch.as_tensor(stream, device=dev))
    t0 = int(res["t0"][0])
    nid = int(res["n_id"][0])
    # extract the 4-symbol SSB tile at the found timing and decode PBCH
    fft = fp.fft_size
    syms = np.stack([stream[0, t0 + l * fft: t0 + (l + 1) * fft]
                     for l in range(4)])
    grid = np.fft.fft(syms, axis=-1) / np.sqrt(fft)
    start = (fft - 240) // 2
    bins = (start + np.arange(240) - fft // 2) % fft
    rx_tile = torch.as_tensor(grid[:, bins][None, None].astype(np.complex64), device=dev)
    pb_payload, pb_ok = ssb_receive(PbchConfig(n_id=nid), rx_tile)
    pbch_ok = bool(pb_ok[0])
    print(f"[sync] n_id={nid} (expected {args.cell_id}) t0={t0} "
          f"pbch_crc_ok={pbch_ok} ({time.time()-t_start:.2f}s)")
    if nid != args.cell_id or not pbch_ok:
        print("UE softmodem NOK")
        return 1
    print(f"[mib] {mib_line(mib_unpack(pb_payload[0]))}")

    # ---- 2. connected loop through the UE MAC/PHY seam -------------------
    # (fapi/ue_if.py, nr_ue_if_module analog): the MAC fills a
    # dl_config_request per slot; the PHY answers with a dl_indication
    rnti = 0x1234
    grant = dict(mcs=args.mcs, prb_start=0, n_prb=args.n_prb, rv=0)
    pdsch = PdschConfig(mu=1, n_prb=args.n_prb, mcs=args.mcs, rnti=rnti,
                        n_id=args.cell_id, start_symbol=2, n_symbols=12,
                        dmrs_symbols=(2,))
    dci_cfg = DciConfig(A=DCI_A, aggregation_level=4, rnti=rnti,
                        n_id=args.cell_id, coreset_prb=args.n_prb)
    phy = UePhy(mu=1, n_bwp_prb=args.n_prb, device=dev)
    grant_bits = torch.as_tensor(encode_grant(**grant)[None], device=dev)
    n_ok = 0
    lat = []
    # CFO tracking state: slot-rate phase-locked loop.  The per-slot
    # common phase is measured from the DMRS LS estimate's rotation
    # against the previous slot; the loop integrates it into a frequency
    # estimate and pre-derotates each incoming slot (the reference's
    # UE_fo_compensation + nr_adjust_synch_ue loop at simulation level).
    t_slot = fp.samples_per_slot(0) / fp.sample_rate
    sym_t = ((fp.symbol_offsets(0) + fp.cp_lengths(0))
             / fp.sample_rate)                    # symbol payload times
    freq_hat = 0.0
    prev_hp = None
    dmrs_sc = _rs.dmrs_type1_sc_indices(args.n_prb, 0)

    def rotation(ph):
        return torch.as_tensor(np.exp(1j * ph).astype(np.complex64),
                               device=dev)[None, None, :, None]

    for slot in range(args.n_slots):
        tb_np = rng.integers(0, 2, (1, pdsch.tbs)).astype(np.int8)
        tb = torch.as_tensor(tb_np, device=dev)
        grid_re, _ = pusch_tx_grid(pdsch, tb)
        grid_re[:, 0, 0, :] += pdcch_tx_grid(dci_cfg, grant_bits)
        shape = (1, 1) + tuple(grid_re.shape[2:])
        noise = (noise_amp / np.sqrt(2) * (
            rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
        rx_grid = grid_re[:, 0][:, None] + torch.as_tensor(noise.astype(np.complex64),
                                                           device=dev)
        if args.cfo:
            # small-CFO model: common phase per symbol (ICI neglected)
            rx_grid = rx_grid * rotation(2 * np.pi * args.cfo * (slot * t_slot + sym_t))
            # tracking: pre-derotate with the loop's frequency estimate
            rx_grid = rx_grid * rotation(-2 * np.pi * freq_hat * (slot * t_slot + sym_t))
            hp = rx_grid[0, 0, 2, :].cpu().numpy()[dmrs_sc] \
                * np.conj(pdsch.dmrs_pilot_np(2))
            if prev_hp is not None:
                dphi = float(np.angle(np.sum(hp * np.conj(prev_hp))))
                freq_hat += 0.5 * dphi / (2 * np.pi * t_slot)
            prev_hp = hp

        t1 = time.time()
        req = DlConfigRequest(slot=0, dci=(DlDciSearch(
            rnti=rnti, coreset_prb=args.n_prb, n_id=args.cell_id),))
        ind = phy.handle_dl(req, rx_grid)
        ok = (bool(ind.pdsch)
              and bool(ind.pdsch[0][1][0])
              and bool(torch.equal(ind.pdsch[0][0].cpu(), torch.as_tensor(tb_np))))
        lat.append(time.time() - t1)
        n_ok += ok
    print(f"[data] {n_ok}/{args.n_slots} slots decoded through the MAC/PHY "
          f"seam (median latency {np.median(lat)*1e3:.1f} ms incl. host loop)")
    if args.cfo:
        print(f"[cfo] applied {args.cfo:.1f} Hz, tracked {freq_hat:.1f} Hz")
    # with CFO the loop needs up to 2 lock-in slots (the reference seeds
    # its loop from the initial-sync estimate; this sim starts cold)
    need = args.n_slots - (2 if args.cfo else 0)
    ok_all = n_ok >= need and (not args.cfo
                               or abs(freq_hat - args.cfo) < 0.2 * abs(args.cfo))
    print("UE softmodem OK" if ok_all else "UE softmodem NOK")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
