"""Connected-mode steady-state data plane over the air (two processes).

Port of openairinterface5g_tpu/runtime/connected_ota.py.  Picks up where
runtime/ra_ota.py stops (msg4/C-RNTI): N slots of scheduled DL+UL data
through the native rfsim IQ hub, with every control and data bit crossing
the air interface:

  repeating 4-slot cycle (slot t = 4*cycle):
    t+0 DL : PDCCH DCI(C-RNTI) DL grant [symbol 0] + PDCCH UL grant
             [symbol 1] + PDSCH transport block (new or HARQ retx)
    t+1 UL : PUCCH F0 HARQ-ACK for the t+0 TB; every 4th cycle also
             PUCCH F2 carrying the 4-bit CQI report
    t+2 UL : PUSCH transport block per the t+0 UL grant (new or retx)
    t+3    : guard

The gNB side runs the l2.mac MacScheduler for PF allocation, HARQ
process management (rv sequence {0,2,3,1}, NDI toggling) and CQI-driven
link adaptation; the UE keeps per-process soft-combining buffers and
reports CQI measured from its own DMRS channel estimate.  The in-hub
channel model adds enough noise that round-0 decodes genuinely fail at
the scheduled MCS, so HARQ retransmissions are exercised over the air.

Each endpoint runs its PHY in torch on `device` (the card unless told
otherwise), on a CUDA stream of its own; the MAC, HARQ and RLC state stays
on the host, and each decision reads the device once.  The hub's AWGN comes
from its own seeded generator, so a run sees the JAX run's noise.

Reference anchors: UE steady loop nr-ue.c:762 + phy_procedures_nr_ue.c
:838 (pbch_pdcch_processing) / :1004 (pdsch_processing); gNB per-slot
gNB_dlsch_ulsch_scheduler (gNB_scheduler.c:191) + tx_func/rx_func
(nr-gnb.c:110/:209).

Run:
  python -m openairinterface5g_tpu_torch.runtime.connected_ota gnb --slots 120
  python -m openairinterface5g_tpu_torch.runtime.connected_ota ue
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import make_frame_params
from ..fapi import messages as fapi
from ..l2.mac import MacScheduler, SchedulerConfig
from ..l2.pdcp import DIR_DL, DIR_UL
from ..l2.userplane import DrbStack
from ..models.gnb import PdcchPdu, SlotDlConfig, gnb_dl_slot, place_pucch_tile
from ..models.pdcch import DciConfig, blind_search
from ..models.pdsch import PdschConfig
from ..models.pucch import (Pucch0Config, Pucch2Config, pucch0_rx, pucch0_tx, pucch2_rx,
                            pucch2_tx)
from ..models.pusch import PuschConfig, pusch_channel_estimate, pusch_rx_grid, pusch_tx
from ..models.ue import DCI_A, UeConfig, decode_grant, encode_grant, ue_receive_slot
from ..phy.ofdm import map_to_grid, ofdm_modulate
from ..radio.rfsim import RfSimDevice
from ..sim import resolve_device
from . import endpoint_stream, re_grid, to_numpy

CELL_ID = 101
BWP_PRB = 48
C_RNTI = 0x2E11
N_CYCLES_DEFAULT = 30
CQI_PERIOD = 4               # F2 CQI report every 4 cycles
NOISE_SIGMA = 0.10           # in-hub AWGN: round-0 BLER nonzero at high MCS

_DL_SYM = dict(start_symbol=2, n_symbols=12, dmrs_symbols=(2,))


def _pdsch_cfg(mcs: int, prb_start: int, n_prb: int):
    return PdschConfig(mu=1, n_prb=n_prb, prb_start=prb_start,
                       n_bwp_prb=BWP_PRB, mcs=mcs, rnti=C_RNTI,
                       n_id=CELL_ID, **_DL_SYM)


def _pusch_cfg(mcs: int, prb_start: int, n_prb: int):
    return PuschConfig(mu=1, n_prb=n_prb, prb_start=prb_start,
                       n_bwp_prb=BWP_PRB, mcs=mcs, rnti=C_RNTI,
                       n_id=CELL_ID)


def _pucch0():
    return Pucch0Config(n_bits=1, n_symbols=1, start_symbol=13,
                        initial_cs=(C_RNTI % 12), hopping_id=CELL_ID)


def _pucch2():
    return Pucch2Config(n_bits=4, n_prb=4, n_symbols=1, start_symbol=13,
                        rnti=C_RNTI, n_id=CELL_ID)


_PUCCH2_PRB = 40             # F2 allocation, disjoint from the F0 PRB 0


def _traffic(seq: int, n_bytes: int) -> bytes:
    """Deterministic seq-stamped payload (integrity via the TB CRC)."""
    rng = np.random.default_rng(0xC0FFEE ^ seq)
    head = seq.to_bytes(4, "big")
    return head + rng.integers(0, 256, max(0, n_bytes - 4),
                               dtype=np.uint8).tobytes()


def _snr_to_cqi(snr_db: float) -> int:
    """Aggressive mapping (+3 vs the nominal working point): the link
    deliberately runs at the MCS edge so round-0 failures occur and the
    HARQ + link-adaptation loops are genuinely exercised (the scheduler's
    target_bler then holds the operating point)."""
    return int(np.clip(round(snr_db / 1.9) + 5, 1, 15))


def _tb_bytes(bits: torch.Tensor) -> bytes:
    return np.packbits(to_numpy(bits).astype(np.uint8)).tobytes()


def run_gnb(port: int, n_cycles: int = N_CYCLES_DEFAULT, log=print,
            l2_stack: bool = False, device: str | torch.device = "cuda") -> dict:
    """gNB endpoint.  Returns the session stats dict (nonzero DL+UL
    throughput and at least one HARQ retransmission = success).

    l2_stack=True: TB payloads carry a real user plane — PDCP(NEA2) +
    RLC AM PDUs in MAC subPDU framing (l2/userplane.DrbStack); packets
    lost to exhausted HARQ rounds are recovered by RLC ARQ."""
    tdev = resolve_device(str(device))
    fp = make_frame_params(1, BWP_PRB)
    S = fp.samples_per_slot(0)
    dev = RfSimDevice.listen(port, n_ant=1)
    dev.set_channel(np.array([1.0, 0.12 + 0.05j], np.complex64),
                    noise_sigma=NOISE_SIGMA)

    mac = MacScheduler(SchedulerConfig(n_bwp_prb=BWP_PRB, mu=1,
                                       n_dl_symbols=12, n_ul_symbols=13,
                                       target_bler=0.3))
    ue = mac.add_ue(C_RNTI, cqi=11)

    stats = dict(dl_tx=0, dl_ack=0, dl_retx=0, dl_bits=0,
                 ul_rx=0, ul_ok=0, ul_retx=0, ul_bits=0,
                 slots=0, mcs_trace=[])
    dl_payloads: dict[int, tuple] = {}   # harq_id -> (cfg, tb_bits, seq)
    ul_pend: dict[int, dict] = {}        # harq_id -> {cfg, rv, harq_buf}
    ul_harq_bufs: dict[int, object] = {}
    last_dl_hid = None
    seq = 0
    drb = None
    if l2_stack:
        drb = DrbStack(DIR_DL)
        stats["ul_pkts"] = 0

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a[None], device=tdev)

    try:
        with endpoint_stream(tdev):
            for cyc in range(n_cycles):
                t = 4 * cyc
                # ---- t+0: schedule + transmit DL data and UL grant ------
                # full-buffer traffic, but one TB in flight per direction: a
                # pending retransmission empties the buffer so the PF pass
                # doesn't also start a new process this slot
                dl_retx_pending = any(h.active and h.round > 0
                                      for h in ue.dl_harq)
                ul_retx_pending = any(h.active and h.round > 0
                                      for h in ue.ul_harq)
                ue.dl_buffer = 0 if dl_retx_pending else 1 << 20
                mac.on_bsr(C_RNTI, 0 if ul_retx_pending else 1 << 20)
                dl_req, ul_req, _ = mac.schedule_slot(0, t % 20)
                pdus = [p for p in dl_req.pdsch if p.rnti == C_RNTI]
                upds = [p for p in ul_req.pusch if p.rnti == C_RNTI]
                assert pdus and upds, "scheduler must allocate both directions"
                pd, pu = pdus[0], upds[0]
                cfgd = _pdsch_cfg(pd.mcs, pd.rb_start, pd.rb_size)
                if pd.new_data:
                    seq += 1
                    tb = np.zeros(cfgd.tbs, np.int8)
                    if drb is not None:
                        # keep the PDCP/RLC pipe fed with seq-stamped packets
                        while len(drb.rlc.queue) < 4:
                            seq += 1
                            drb.send_packet(_traffic(seq, 300))
                        pay = drb.fill_tb(cfgd.tbs // 8)
                    else:
                        pay = _traffic(seq, cfgd.tbs // 8)
                    bits = np.unpackbits(np.frombuffer(pay, np.uint8))[: cfgd.tbs]
                    tb[: len(bits)] = bits
                    dl_payloads[pd.harq_process_id] = (cfgd, tb, seq)
                else:
                    stats["dl_retx"] += 1
                    cfgd, tb, _ = dl_payloads[pd.harq_process_id]
                last_dl_hid = pd.harq_process_id
                dci_dl = DciConfig(A=DCI_A, aggregation_level=4, rnti=C_RNTI,
                                   n_id=CELL_ID, coreset_prb=BWP_PRB,
                                   start_symbol=0)
                dci_ul = DciConfig(A=DCI_A, aggregation_level=4, rnti=C_RNTI,
                                   n_id=CELL_ID, coreset_prb=BWP_PRB,
                                   start_symbol=1)
                g_dl = encode_grant(mcs=pd.mcs, prb_start=pd.rb_start,
                                    n_prb=pd.rb_size, rv=pd.rv, ndi=pd.new_data,
                                    harq_id=pd.harq_process_id)
                g_ul = encode_grant(mcs=pu.mcs, prb_start=pu.rb_start,
                                    n_prb=pu.rb_size, rv=pu.rv, ndi=pu.new_data,
                                    harq_id=pu.harq_process_id)
                dl0 = SlotDlConfig(mu=1, n_bwp_prb=BWP_PRB, pdsch=(cfgd,),
                                   pdcch=(PdcchPdu(dci_dl), PdcchPdu(dci_ul)),
                                   slot=t % 20)
                tx0, _ = gnb_dl_slot(dl0, [on_dev(tb)],
                                     dci_payloads=[on_dev(g_dl), on_dev(g_ul)],
                                     rvs=[pd.rv])
                dev.write(t * S, to_numpy(tx0[0, 0]))
                stats["dl_tx"] += 1
                stats["mcs_trace"].append((pd.mcs, pu.mcs))

                # remember the UL expectation for t+2
                cfgu = _pusch_cfg(pu.mcs, pu.rb_start, pu.rb_size)
                ul_pend[pu.harq_process_id] = dict(
                    cfg=cfgu, rv=pu.rv, new=pu.new_data, hid=pu.harq_process_id)

                # ---- t+1: PUCCH (ACK + periodic CQI) --------------------
                rx1 = dev.read((t + 1) * S, S)
                grid1 = re_grid(fp, rx1, (t + 1) % 20, tdev)
                p0 = _pucch0()
                tile = grid1[:, :, p0.start_symbol: p0.start_symbol + 1, :12]
                uci, _ = pucch0_rx(p0, tile)
                ack = bool(uci[0] == 1)
                prev_tbs = dl_payloads[last_dl_hid][0].tbs
                mac.on_dl_ack(C_RNTI, last_dl_hid, ack)
                if ack:
                    stats["dl_ack"] += 1
                    stats["dl_bits"] += prev_tbs
                if cyc % CQI_PERIOD == 0:
                    p2 = _pucch2()
                    sc = 12 * _PUCCH2_PRB
                    rx2t = grid1[:, :, p2.start_symbol: p2.start_symbol + 1,
                                 sc: sc + 12 * p2.n_prb]
                    cqi_bits, ok2 = pucch2_rx(p2, rx2t)
                    read = to_numpy(torch.cat([ok2[:1, None].long(), cqi_bits[:1].long()],
                                              dim=1))[0]        # ok, then the bits
                    if bool(read[0]):
                        cqi = int("".join(str(int(b)) for b in read[1:]), 2)
                        mac.on_uci_cqi(C_RNTI, cqi)
                        log(f"[gnb] cyc{cyc} CQI report {cqi} "
                            f"(mcs_offset {ue.mcs_offset})")

                # ---- t+2: PUSCH receive ---------------------------------
                rx2 = dev.read((t + 2) * S, S)
                pend = ul_pend.pop(pu.harq_process_id)
                cfgu = pend["cfg"]
                grid2 = re_grid(fp, rx2, (t + 2) % 20, tdev)
                buf = None if pend["new"] else ul_harq_bufs.get(pend["hid"])
                out = pusch_rx_grid(cfgu, grid2, rv=pend["rv"], n_iters=10,
                                    harq_buffers=buf)
                ok = bool(out["tb_ok"][0])
                stats["ul_rx"] += 1
                if not pend["new"]:
                    stats["ul_retx"] += 1
                if ok:
                    stats["ul_bits"] += cfgu.tbs
                    stats["ul_ok"] += 1
                    ul_harq_bufs.pop(pend["hid"], None)
                    if drb is not None:
                        drb.drain_tb(_tb_bytes(out["tb_bits"][0]))
                        stats["ul_pkts"] = len(drb.delivered)
                else:
                    ul_harq_bufs[pend["hid"]] = out["harq_buffers"]
                mac.on_crc(fapi.CrcIndication(
                    sfn=0, slot=(t + 2) % 20,
                    crcs=((0, C_RNTI, pend["hid"], ok),)), ul=True)
                log(f"[gnb] cyc{cyc} DL mcs{pd.mcs} rv{pd.rv} "
                    f"{'ACK' if ack else 'NACK'} | UL mcs{pu.mcs} rv{pu.rv} "
                    f"crc={'OK' if ok else 'FAIL'}")
                stats["slots"] = 4 * (cyc + 1)
    finally:
        dev.close()

    if drb is not None:
        # integrity: every delivered UL packet carries its seq stamp
        stats["ul_pkts_intact"] = sum(
            1 for p in drb.delivered
            if p == _traffic(int.from_bytes(p[:4], "big"), 300))
    dur_s = stats["slots"] * 0.5e-3
    stats["dl_mbps"] = stats["dl_bits"] / dur_s / 1e6
    stats["ul_mbps"] = stats["ul_bits"] / dur_s / 1e6
    log(f"[gnb] {stats['slots']} slots: DL {stats['dl_mbps']:.2f} Mb/s "
        f"({stats['dl_ack']}/{stats['dl_tx']} acked, {stats['dl_retx']} "
        f"retx) | UL {stats['ul_mbps']:.2f} Mb/s ({stats['ul_ok']}/"
        f"{stats['ul_rx']} ok, {stats['ul_retx']} retx)")
    return stats


def run_ue(port: int, host: str = "127.0.0.1",
           n_cycles: int = N_CYCLES_DEFAULT, log=print,
           l2_stack: bool = False, device: str | torch.device = "cuda") -> dict:
    """UE endpoint: decode grants + data, ACK/CQI on PUCCH, PUSCH UL."""
    tdev = resolve_device(str(device))
    fp = make_frame_params(1, BWP_PRB)
    S = fp.samples_per_slot(0)
    dev = RfSimDevice.connect(host, port, n_ant=1)
    dev.set_channel(np.array([1.0, 0.12 + 0.05j], np.complex64),
                    noise_sigma=NOISE_SIGMA)
    uecfg = UeConfig(mu=1, n_bwp_prb=BWP_PRB, rnti=C_RNTI, n_id=CELL_ID,
                     coreset_prb=BWP_PRB)
    dl_bufs: dict[int, object] = {}
    ul_tbs: dict[int, tuple] = {}        # harq_id -> (cfg, tb)
    stats = dict(dl_ok=0, dl_rx=0, ul_tx=0)
    cqi = 11
    drb = None
    if l2_stack:
        drb = DrbStack(DIR_UL)
    try:
        with endpoint_stream(tdev):
            for cyc in range(n_cycles):
                t = 4 * cyc
                # ---- t+0: DL grants + data ------------------------------
                rx0 = dev.read(t * S, S)
                grid0 = re_grid(fp, rx0, t % 20, tdev)
                out = ue_receive_slot(uecfg, grid0, n_iters=10, slot=t % 20,
                                      harq_buffers=None)
                ack = 0
                if out["grant"] is not None:
                    g = out["grant"]
                    hid = g["harq_id"]
                    if g["ndi"] == 0 and hid in dl_bufs:
                        out = ue_receive_slot(uecfg, grid0, n_iters=10,
                                              slot=t % 20,
                                              harq_buffers=dl_bufs[hid])
                    ok = bool(out["tb_ok"][0])
                    stats["dl_rx"] += 1
                    if ok:
                        stats["dl_ok"] += 1
                        dl_bufs.pop(hid, None)
                        ack = 1
                        if drb is not None:
                            drb.drain_tb(_tb_bytes(out["tb_bits"][0]))
                            stats["dl_pkts"] = len(drb.delivered)
                    else:
                        dl_bufs[hid] = out["harq_buffers"]
                    # CQI from own DMRS channel estimate + noise floor
                    h, nvar = pusch_channel_estimate(out["cfg"], grid0)
                    snr = 10 * np.log10(float(
                        torch.mean(torch.abs(h) ** 2)
                        / torch.clamp(nvar.mean(), min=1e-9)))
                    cqi = _snr_to_cqi(snr)
                # UL grant from the symbol-1 coreset
                cs1 = grid0[:, :, 1, : 12 * BWP_PRB]
                ubits, ufound, _ = blind_search(cs1, DCI_A, C_RNTI,
                                                n_id=CELL_ID, slot=t % 20,
                                                coreset_prb=BWP_PRB,
                                                start_symbol=1)
                found_bits = to_numpy(torch.cat([ufound.any()[None].to(torch.int8),
                                                 ubits[0]]))
                ugrant = decode_grant(found_bits[1:]) if found_bits[0] else None

                # ---- t+1: PUCCH ACK (+ periodic CQI) --------------------
                grid_ul = torch.zeros((1, 1, fp.symbols_per_slot, fp.n_sc),
                                      dtype=torch.complex64, device=tdev)
                p0 = _pucch0()
                grid_ul = place_pucch_tile(
                    grid_ul, pucch0_tx(p0, torch.as_tensor([ack], device=tdev)), p0, 0)
                if cyc % CQI_PERIOD == 0:
                    p2 = _pucch2()
                    cqi_bits = torch.as_tensor(np.array(
                        [[(cqi >> (3 - i)) & 1 for i in range(4)]], np.int8), device=tdev)
                    tile2 = pucch2_tx(p2, cqi_bits)  # (1, syms, 12*n_prb)
                    sc = 12 * _PUCCH2_PRB
                    grid_ul[:, 0, p2.start_symbol: p2.start_symbol + 1,
                            sc: sc + 12 * p2.n_prb] += tile2
                tx1 = ofdm_modulate(fp, map_to_grid(fp, grid_ul[:, 0]),
                                    (t + 1) % 20)
                dev.write((t + 1) * S, to_numpy(tx1[0]))

                # ---- t+2: PUSCH per the UL grant ------------------------
                if ugrant is not None:
                    hid = ugrant["harq_id"]
                    cfgu = _pusch_cfg(ugrant["mcs"], ugrant["prb_start"],
                                      ugrant["n_prb"])
                    if ugrant["ndi"] == 1 or hid not in ul_tbs:
                        if drb is not None:
                            while len(drb.rlc.queue) < 4:
                                stats["ul_seq"] = stats.get("ul_seq", 0) + 1
                                drb.send_packet(_traffic(stats["ul_seq"], 300))
                            pay = drb.fill_tb(cfgu.tbs // 8)
                        else:
                            pay = _traffic(0x8000 + 16 * cyc + hid,
                                           cfgu.tbs // 8)
                        tbb = np.zeros(cfgu.tbs, np.int8)
                        bits = np.unpackbits(np.frombuffer(pay, np.uint8)
                                             )[: cfgu.tbs]
                        tbb[: len(bits)] = bits
                        ul_tbs[hid] = (cfgu, tbb)
                    cfgu, tbb = ul_tbs[hid]
                    tx2, _ = pusch_tx(cfgu, torch.as_tensor(tbb[None], device=tdev),
                                      rv=ugrant["rv"])
                    dev.write((t + 2) * S, to_numpy(tx2[0, 0]))
                    stats["ul_tx"] += 1
                else:
                    dev.write((t + 2) * S, np.zeros(S, np.complex64))
                log(f"[ue] cyc{cyc} dl_ok={bool(ack)} cqi={cqi} "
                    f"ul_grant={'mcs%d rv%d' % (ugrant['mcs'], ugrant['rv']) if ugrant else None}")
        time.sleep(1.5)      # linger so the peer drains the last slots
    finally:
        dev.close()
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="connected-mode DL+UL data plane over rfsim")
    ap.add_argument("role", choices=["gnb", "ue"])
    ap.add_argument("--port", type=int, default=47011)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--slots", type=int, default=4 * N_CYCLES_DEFAULT)
    ap.add_argument("--l2", action="store_true",
                    help="carry a PDCP(NEA2)+RLC-AM user plane in the TBs")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n_cycles = max(1, args.slots // 4)
    if args.role == "gnb":
        st = run_gnb(args.port, n_cycles, l2_stack=args.l2, device=args.device)
        good = (st["dl_mbps"] > 0 and st["ul_mbps"] > 0
                and (st["dl_retx"] + st["ul_retx"]) > 0)
        print("CONNECTED data plane OK" if good else "CONNECTED NOK", st)
        return 0 if good else 1
    st = run_ue(args.port, args.host, n_cycles, l2_stack=args.l2, device=args.device)
    print("UE session done", st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
