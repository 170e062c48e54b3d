"""lte-softmodem-style loop: eNB and UE over a 2-tap channel, the LTE MAC
scheduler and the RRC connected stack driving scheduled transport blocks in
both directions.

Port of openairinterface5g_tpu/runtime/lte_softmodem.py (the reference's
lte-softmodem.c main loop, eNB_scheduler.c:539, rrc_eNB.c), with its
constants, subframe plan and log lines:

  phase 1  RRC connect: request / setup / complete, security, reconfiguration,
           every message carried inside PDSCH / PUSCH transport blocks
  phase 2  N 4-subframe cycles of full-buffer data:
    sf+0 DL: PDCCH (DL and UL DCI, two blind-decoded candidates) + PDSCH TB
             (new or HARQ retransmission per the scheduler)
    sf+1 UL: PUCCH 1a HARQ-ACK (+ PUCCH 2 CQI every 4th cycle)
    sf+2 UL: PUSCH TB per the UL grant (synchronous HARQ)
    sf+3    guard

The channel's AWGN comes from a torch.Generator on the loop's device, seeded
from `seed` (the JAX package's jax.random stream cannot be reproduced).  The
PHY runs on the device; the MAC and RRC on the host read the device once per
decision: the RRC TB, the two DCIs with the UE's channel gain, the PDSCH
CRC, the PUCCH reports, the PUSCH CRC.

Run: python -m openairinterface5g_tpu_torch.runtime.lte_softmodem --cycles 25
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..lte.mac import DCI_A, EnbScheduler, EnbSchedulerConfig, pack_dci, unpack_dci
from ..lte.params import (extract_from_grid, make_lte_frame_params, map_to_grid,
                          ofdm_demodulate, ofdm_modulate)
from ..lte.pdcch import pdcch_blind_decode, pdcch_tx_symbol0
from ..lte.pdsch import LtePdschConfig, crs_channel_estimate, pdsch_rx, pdsch_tx
from ..lte.pucch import LtePucch1Config, LtePucch2Config, pucch1_rx, pucch1_tx, pucch2_rx, pucch2_tx
from ..lte.pusch import LtePuschConfig, pusch_rx, pusch_tx
from ..lte.rrc import EnbRrc, LteUeRrc
from ..sim import resolve_device

N_RB = 25
CELL_ID = 17
C_RNTI = 0x4444
NOISE_SIGMA_FRAC = 0.10      # noise relative to signal (per-RE ~14 dB SNR)


def _traffic(seq: int, n_bytes: int) -> bytes:
    rng = np.random.default_rng(0x17E ^ seq)
    return seq.to_bytes(4, "big") + rng.integers(
        0, 256, max(0, n_bytes - 4), dtype=np.uint8).tobytes()


def _to_tb(payload: bytes, tbs: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))[:tbs]
    tb = np.zeros(tbs, np.int8)
    tb[: len(bits)] = bits
    return tb


def _from_tb(bits: np.ndarray, n_bytes: int) -> bytes:
    return np.packbits(np.asarray(bits[: 8 * n_bytes]).astype(np.uint8)).tobytes()


def _host(*xs: torch.Tensor) -> list:
    """One device read of the first rows of xs, each flattened to float32."""
    flat = torch.cat([x[0].reshape(-1).to(torch.float32) for x in xs]).cpu().numpy()
    out, i = [], 0
    for x in xs:
        n = x[0].numel()
        out.append(flat[i: i + n])
        i += n
    return out


def run_loop(n_cycles: int = 25, seed: int = 0, log=print,
             device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(str(device))
    fp = make_lte_frame_params(N_RB)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def chan(tx):
        """2-tap static channel + AWGN (the lte_sim channel slot)."""
        h2 = 0.25 + 0.15j
        rx = tx + h2 * torch.nn.functional.pad(tx, (3, 0))[..., : tx.shape[-1]]
        sig = torch.sqrt(torch.mean(tx.abs() ** 2))
        noise = torch.complex(torch.randn(rx.shape, generator=gen, device=dev),
                              torch.randn(rx.shape, generator=gen, device=dev))
        return rx + NOISE_SIGMA_FRAC * sig * noise * np.float32(np.sqrt(0.5))

    def tb_tensor(tb: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(tb[None], device=dev)

    # ---------------- RRC connect (messages inside TBs) -----------------
    dl_rrc_q: list[bytes] = []
    ul_rrc_q: list[bytes] = []
    enb_rrc = EnbRrc(send=lambda rnti, pdu: dl_rrc_q.append(pdu))
    ue_rrc = LteUeRrc(send=lambda pdu: ul_rrc_q.append(pdu))
    ue_rrc.connect()

    cfg_sig_d = LtePdschConfig(n_rb=N_RB, n_prb=N_RB, mcs=6, cell_id=CELL_ID, rnti=C_RNTI,
                               subframe=1)
    cfg_sig_u = LtePuschConfig(n_rb=N_RB, n_prb=N_RB, mcs=6, cell_id=CELL_ID, rnti=C_RNTI,
                               subframe=2)

    def signalling(cfg, tx_fn, rx_fn, pdu: bytes, what: str) -> bytes:
        tb = _to_tb(len(pdu).to_bytes(2, "big") + pdu, cfg.tbs)
        out = rx_fn(cfg, chan(tx_fn(cfg, tb_tensor(tb))[0]), n_iters=6)
        ok, bits = _host(out["tb_ok"], out["tb_bits"])
        assert bool(ok[0]), f"RRC {what} TB failed"
        raw = _from_tb(bits.astype(np.int8), cfg.tbs // 8)
        return raw[2: 2 + int.from_bytes(raw[:2], "big")]

    n_rrc = 0
    while ul_rrc_q or dl_rrc_q:
        if ul_rrc_q:                      # UE -> eNB over PUSCH
            msg = signalling(cfg_sig_u, pusch_tx, pusch_rx, ul_rrc_q.pop(0), "UL")
            if ue_rrc.state == "REQUESTING" and not enb_rrc.ues:
                enb_rrc.on_ccch(C_RNTI, msg)
            else:
                enb_rrc.on_dcch(C_RNTI, msg)
            n_rrc += 1
        if dl_rrc_q:                      # eNB -> UE over PDSCH
            ue_rrc.on_dl(signalling(cfg_sig_d, pdsch_tx, pdsch_rx, dl_rrc_q.pop(0), "DL"))
            n_rrc += 1
    assert ue_rrc.state == "ACTIVE" and enb_rrc.ues[C_RNTI].state == "ACTIVE"
    log(f"[lte] RRC connected in {n_rrc} signalling TBs: "
        f"eNB={enb_rrc.ues[C_RNTI].state} UE={ue_rrc.state} "
        f"drbs={ue_rrc.drbs}")

    # ---------------- connected-mode data loop --------------------------
    mac = EnbScheduler(EnbSchedulerConfig(n_rb=N_RB))
    mac.add_ue(C_RNTI, cqi=10)
    stats = dict(dl_tx=0, dl_ack=0, dl_retx=0, dl_bits=0,
                 ul_rx=0, ul_ok=0, ul_retx=0, ul_bits=0, subframes=0)
    dl_tbs: dict[int, np.ndarray] = {}
    ue_dl_streams: dict[int, list] = {}
    ue_ul_tbs: dict[int, np.ndarray] = {}
    enb_ul_streams: dict[int, list] = {}
    seq = 0
    cqi_est = 10
    p0 = LtePucch1Config(n_rb=N_RB, cell_id=CELL_ID, prb=0, n_oc=1, cs0=2)
    p2 = LtePucch2Config(n_rb=N_RB, cell_id=CELL_ID, prb=1, cs0=4, rnti=C_RNTI, n_bits=4)

    for cyc in range(n_cycles):
        sf = 1 + (cyc % 4)     # avoid sf 0/5 (PSS/SSS/PBCH region)
        # --- DL: schedule + PDCCH + PDSCH ---
        gd = mac.schedule_dl(C_RNTI)
        gu = mac.schedule_ul(C_RNTI, sf)
        cfg_d = LtePdschConfig(n_rb=N_RB, n_prb=gd["n_prb"], prb_start=gd["prb_start"],
                               mcs=gd["mcs"], cell_id=CELL_ID, rnti=C_RNTI, subframe=sf)
        if gd["ndi"]:
            seq += 1
            tb = _to_tb(_traffic(seq, cfg_d.tbs // 8), cfg_d.tbs)
            dl_tbs[gd["harq_id"]] = tb
            mac.ues[C_RNTI].dl_harq[gd["harq_id"]].tb = tb
        else:
            stats["dl_retx"] += 1
            # the same TB; scrambling and CRS follow the current subframe
            tb = dl_tbs[gd["harq_id"]]
        # eNB: two AL-2 DCIs (the 25-PRB symbol-0 region has 4 CCEs) + PDSCH
        pay = torch.as_tensor(np.stack([pack_dci(**gd), pack_dci(**gu)]), device=dev)
        row = (pdcch_tx_symbol0(N_RB, CELL_ID, sf, pay[:1], C_RNTI, aggregation=2, cce0=0)
               + pdcch_tx_symbol0(N_RB, CELL_ID, sf, pay[1:2], C_RNTI, aggregation=2, cce0=2))
        tx, _ = pdsch_tx(cfg_d, tb_tensor(tb), rv=gd["rv"], pdcch_row=row)
        rx_dl = chan(tx)

        # --- UE receive: blind decode both DCIs, decode PDSCH w/ HARQ ---
        grid = extract_from_grid(fp, ofdm_demodulate(fp, rx_dl))
        cfg_ce = LtePdschConfig(n_rb=N_RB, cell_id=CELL_ID, rnti=C_RNTI, subframe=sf)
        h, _ = crs_channel_estimate(cfg_ce, grid)
        y0 = grid[:, :, 0, :]
        pl, found, _ = pdcch_blind_decode(y0, h, N_RB, CELL_ID, sf, C_RNTI, DCI_A,
                                          aggregations=(2,), cce0_list=(0,))
        pl2, found2, _ = pdcch_blind_decode(y0, h, N_RB, CELL_ID, sf, C_RNTI, DCI_A,
                                            aggregations=(2,), cce0_list=(2,))
        found, pl, found2, pl2, gain = _host(found, pl, found2, pl2,
                                             torch.mean(h.abs() ** 2)[None])
        ack = 0
        if found[0]:
            g = unpack_dci(pl.astype(np.int8))
            cfg_rx = LtePdschConfig(n_rb=N_RB, n_prb=g["n_prb"], prb_start=g["prb_start"],
                                    mcs=g["mcs"], cell_id=CELL_ID, rnti=C_RNTI, subframe=sf)
            acc = None if g["ndi"] else ue_dl_streams.get(g["harq_id"])
            out = pdsch_rx(cfg_rx, rx_dl, rv=g["rv"], n_iters=6, acc_streams=acc)
            if bool(out["tb_ok"][0]):
                ack = 1
                ue_dl_streams.pop(g["harq_id"], None)
            else:
                ue_dl_streams[g["harq_id"]] = out["streams"]
        ug = unpack_dci(pl2.astype(np.int8)) if found2[0] else None
        stats["dl_tx"] += 1

        # --- UL sf+1: PUCCH 1a ACK (+ format 2 CQI) ---
        # 1a BPSK: bit 0 -> d = +1 carries the ACK
        pgrid = pucch1_tx(p0, torch.tensor([[1 - ack]], dtype=torch.int8, device=dev))
        if cyc % 4 == 0:
            cqi_bits = torch.tensor([[(cqi_est >> (3 - i)) & 1 for i in range(4)]],
                                    dtype=torch.int8, device=dev)
            pgrid = pgrid + pucch2_tx(p2, cqi_bits)
        rx_ul1 = chan(ofdm_modulate(fp, map_to_grid(fp, pgrid))[:, None])
        ugrid = extract_from_grid(fp, ofdm_demodulate(fp, rx_ul1))
        dec = pucch1_rx(p0, ugrid, n_bits=1)
        reports = [dec["detected"], dec["bits"]]
        if cyc % 4 == 0:
            c2 = pucch2_rx(p2, ugrid)
            reports += [c2["detected"], c2["uci"]]
        reports = _host(*reports)
        got_ack = bool(reports[0][0]) and int(reports[1][0]) == 0
        mac.on_dl_ack(C_RNTI, gd["harq_id"], got_ack)
        if got_ack:
            stats["dl_ack"] += 1
            stats["dl_bits"] += cfg_d.tbs
        if cyc % 4 == 0 and reports[2][0]:
            mac.on_cqi(C_RNTI, int("".join(str(int(b)) for b in reports[3]), 2))

        # --- UL sf+2: PUSCH per the UL grant (synchronous HARQ) ---
        if ug is not None:
            cfg_u = LtePuschConfig(n_rb=N_RB, n_prb=ug["n_prb"], prb_start=ug["prb_start"],
                                   mcs=ug["mcs"], cell_id=CELL_ID, rnti=C_RNTI, subframe=sf)
            hid = ug["harq_id"]
            if ug["ndi"] or hid not in ue_ul_tbs:
                ue_ul_tbs[hid] = _to_tb(_traffic(0x9000 + 8 * cyc + hid, cfg_u.tbs // 8),
                                        cfg_u.tbs)
            rx_ul2 = chan(pusch_tx(cfg_u, tb_tensor(ue_ul_tbs[hid]), rv=ug["rv"])[0])
            acc = None if ug["ndi"] else enb_ul_streams.get(hid)
            out = pusch_rx(cfg_u, rx_ul2, rv=ug["rv"], n_iters=6, acc_streams=acc)
            ok = bool(out["tb_ok"][0])
            stats["ul_rx"] += 1
            if not ug["ndi"]:
                stats["ul_retx"] += 1
            if ok:
                stats["ul_ok"] += 1
                stats["ul_bits"] += cfg_u.tbs
                enb_ul_streams.pop(hid, None)
            else:
                enb_ul_streams[hid] = out["streams"]
            mac.on_ulsch_crc(C_RNTI, sf, ok)
        # CQI estimate from the DL CRS channel (UE side)
        snr = 10 * np.log10(float(gain[0]) / max(2 * NOISE_SIGMA_FRAC ** 2, 1e-9))
        cqi_est = int(np.clip(round(snr / 2.0) + 3, 1, 15))
        stats["subframes"] = 4 * (cyc + 1)
        log(f"[lte] cyc{cyc} sf{sf} DL mcs{gd['mcs']} rv{gd['rv']} "
            f"{'ACK' if got_ack else 'NACK'} | UL mcs{gu['mcs']} "
            f"rv{gu['rv']} {'OK' if ug else 'no-grant'}")

    dur = stats["subframes"] * 1e-3
    stats["dl_mbps"] = stats["dl_bits"] / dur / 1e6
    stats["ul_mbps"] = stats["ul_bits"] / dur / 1e6
    stats["rrc_msgs"] = n_rrc
    log(f"[lte] {stats['subframes']} subframes: DL {stats['dl_mbps']:.2f} "
        f"Mb/s ({stats['dl_ack']}/{stats['dl_tx']} acked, "
        f"{stats['dl_retx']} retx) | UL {stats['ul_mbps']:.2f} Mb/s "
        f"({stats['ul_ok']}/{stats['ul_rx']} ok, {stats['ul_retx']} retx)")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description="lte-softmodem loop")
    ap.add_argument("--cycles", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    st = run_loop(args.cycles, device=args.device)
    good = (st["dl_mbps"] > 0 and st["ul_mbps"] > 0)
    print("LTE softmodem loop OK" if good else "LTE softmodem loop NOK", st)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
