"""Over-the-air random access: gNB + UE endpoints over the rfsim IQ hub.

Port of openairinterface5g_tpu/runtime/ra_ota.py, the 5g_rfsimulator CI
flow analog, with every RA message crossing the air interface as IQ
samples (no message-bus shortcuts):

  slot 0  DL  SSB (real CP-OFDM slot)      -> UE time/cell sync + MIB
  slot 1  UL  PRACH preamble               -> gNB detect (idx, delay)
  slot 2  DL  msg2: PDCCH(RA-RNTI) + PDSCH RAR (TA, TC-RNTI, msg3 grant)
  slot 3  UL  msg3: PUSCH (TC-RNTI) carrying the RRCSetupRequest bytes
  slot 4  DL  msg4: PDCCH(TC-RNTI) + PDSCH contention-resolution MAC CE
  slot 5  UL  PUCCH F0 HARQ-ACK for msg4

Reference anchors: gNB_scheduler_RA.c:1204 (nr_generate_Msg2), :713
(Msg3 scheduling), :1701 (nr_generate_Msg4); UE side nr_ue_procedures.c
RA state machine (here l2/ue_mac.UeMac).

Each endpoint runs its PHY in torch on `device` (the card unless told
otherwise), on a CUDA stream of its own; the samples cross the hub as numpy
complex64, and each decision reads the device once.  The hub is the port's
build of native/rfsim/rfsim.cpp (radio/rfsim.py), whose channel model and
AWGN generator are the JAX package's, so a run sees the JAX run's noise.

Run as two processes:
  python -m openairinterface5g_tpu_torch.runtime.ra_ota gnb --port 47001
  python -m openairinterface5g_tpu_torch.runtime.ra_ota ue  --port 47001
or in-process via run_gnb/run_ue threads.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import make_frame_params
from ..l2.ue_mac import RaConfig, UeMac
from ..models.gnb import PdcchPdu, SlotDlConfig, SsbPdu, gnb_dl_slot, place_pucch_tile
from ..models.pbch import Mib, PbchConfig, mib_payload, ssb_receive
from ..models.pdcch import DciConfig
from ..models.pdsch import PdschConfig
from ..models.prach import PrachTdConfig, prach_td_rx, prach_td_tx
from ..models.pucch import Pucch0Config, pucch0_rx, pucch0_tx
from ..models.pusch import PuschConfig, pusch_rx_grid, pusch_tx
from ..models.sync import pss_search, sss_identify
from ..models.ue import DCI_A, UeConfig, encode_grant, ue_receive_slot
from ..phy.ofdm import map_to_grid, ofdm_modulate
from ..radio.rfsim import RfSimDevice
from ..sim import resolve_device
from . import endpoint_stream, re_grid, to_numpy

CELL_ID = 101
BWP_PRB = 48
SSB_PRB_OFFSET = 14          # centers the 240-SC SSB in the 48-PRB BWP
SSB_SYMBOL = 2
PRACH_PREAMBLE = 23
RA_RNTI = 1 + 14 * 1         # 38.321 §5.1.3: 1 + s_id + 14*t_id (t_id=1)
MSG3_PAYLOAD = b"RRCSetupRequest/5G-S-TMSI:0xDEADBEEF"

# RAR payload bit layout (38.321 §6.2.3 MAC RAR analog)
_RAR_FIELDS = (("preamble", 6), ("ta", 12), ("mcs", 5), ("prb_start", 9),
               ("n_prb", 9), ("tc_rnti", 16))


def _pack_bits(fields, vals) -> np.ndarray:
    bits = []
    for name, nb in fields:
        v = int(vals[name])
        bits.extend((v >> (nb - 1 - i)) & 1 for i in range(nb))
    return np.array(bits, np.int8)


def _unpack_bits(fields, bits) -> dict:
    out, i = {}, 0
    for name, nb in fields:
        v = 0
        for _ in range(nb):
            v = (v << 1) | int(bits[i])
            i += 1
        out[name] = v
    return out


def pack_rar(preamble: int, ta: int, tc_rnti: int, mcs: int,
             prb_start: int, n_prb: int) -> np.ndarray:
    return _pack_bits(_RAR_FIELDS, dict(preamble=preamble, ta=ta, mcs=mcs,
                                        prb_start=prb_start, n_prb=n_prb,
                                        tc_rnti=tc_rnti))


def unpack_rar(bits) -> dict:
    return _unpack_bits(_RAR_FIELDS, bits)


def bytes_to_tb(payload: bytes, tbs: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    assert len(bits) <= tbs, (len(bits), tbs)
    return np.concatenate([bits, np.zeros(tbs - len(bits), np.uint8)]
                          ).astype(np.int8)


def tb_to_bytes(bits: np.ndarray, n_bytes: int) -> bytes:
    return np.packbits(np.asarray(bits[: 8 * n_bytes]).astype(np.uint8)
                       ).tobytes()


def _prach_cfg(fp):
    return PrachTdConfig(fmt="A2", mu=fp.mu, sample_rate=fp.sample_rate,
                         roots=(1, 2, 3, 4), n_cs=23, threshold=8.0)


def _msg_pdsch(mcs: int, n_prb: int, prb_start: int, rnti: int):
    """The fixed time allocation ue_receive_slot assumes (2..13, DMRS 2)."""
    return PdschConfig(mu=1, n_prb=n_prb, prb_start=prb_start,
                       n_bwp_prb=BWP_PRB, mcs=mcs, rnti=rnti, n_id=CELL_ID,
                       start_symbol=2, n_symbols=12, dmrs_symbols=(2,))


def _msg3_pusch(grant: dict, rnti: int):
    return PuschConfig(mu=1, n_prb=grant["n_prb"],
                       prb_start=grant["prb_start"], n_bwp_prb=BWP_PRB,
                       mcs=grant["mcs"], rnti=rnti, n_id=CELL_ID)


def _pucch0(rnti: int):
    return Pucch0Config(n_bits=1, n_symbols=1, start_symbol=13,
                        initial_cs=(rnti % 12), hopping_id=CELL_ID)


def run_gnb(port: int, log=print, device: str | torch.device = "cuda") -> bool:
    """gNB endpoint: serves the RA schedule; returns True when the RA
    completes (PRACH detected, msg3 decoded, msg4 ACKed)."""
    tdev = resolve_device(str(device))
    fp = make_frame_params(1, BWP_PRB)
    S = fp.samples_per_slot(0)
    dev = RfSimDevice.listen(port, n_ant=1)
    # channel model applied INSIDE the native hub to received UL samples
    # (rfsimu_setchanmod_cmd analog): 2-tap FIR + AWGN
    dev.set_channel(np.array([1.0, 0.12 + 0.05j], np.complex64),
                    noise_sigma=0.01)
    ok = True
    try:
        with endpoint_stream(tdev):
            # ---- slot 0: SSB ---------------------------------------------
            dl0 = SlotDlConfig(mu=1, n_bwp_prb=BWP_PRB,
                               ssb=SsbPdu(PbchConfig(n_id=CELL_ID),
                                          prb_offset=SSB_PRB_OFFSET,
                                          start_symbol=SSB_SYMBOL))
            mib = torch.as_tensor(mib_payload(Mib(), sfn=0)[None], device=tdev)
            tx0, _ = gnb_dl_slot(dl0, [], mib)
            dev.write(0, to_numpy(tx0[0, 0]))
            log(f"[gnb] slot0 SSB written ({S} samples)")

            # ---- slot 1: PRACH detection --------------------------------
            rx1 = dev.read(S, S)
            pcfg = _prach_cfg(fp)
            det = prach_td_rx(pcfg, torch.as_tensor(rx1[None, :, : pcfg.n_samples],
                                                    device=tdev))
            detected, preamble, delay = (int(v) for v in to_numpy(torch.stack(
                [det["detected"][0].long(), det["preamble"][0].long(),
                 det["delay"][0].long()])))
            detected = bool(detected)
            log(f"[gnb] slot1 PRACH detected={detected} preamble={preamble} "
                f"delay={delay}")
            if not (detected and preamble == PRACH_PREAMBLE):
                return False

            # ---- slot 2: msg2 RAR over PDCCH+PDSCH ----------------------
            tc_rnti = 0x2E11
            msg3_grant = dict(mcs=4, prb_start=0, n_prb=24)
            rar_cfg = _msg_pdsch(mcs=2, n_prb=12, prb_start=24, rnti=RA_RNTI)
            rar_bits = pack_rar(preamble, delay, tc_rnti, **msg3_grant)
            tb2 = torch.as_tensor(bytes_to_tb(np.packbits(rar_bits.astype(np.uint8)
                                                          ).tobytes(), rar_cfg.tbs)[None],
                                  device=tdev)
            dci2 = DciConfig(A=DCI_A, aggregation_level=4, rnti=RA_RNTI,
                             n_id=CELL_ID, coreset_prb=BWP_PRB)
            grant2 = encode_grant(mcs=2, prb_start=24, n_prb=12)
            dl2 = SlotDlConfig(mu=1, n_bwp_prb=BWP_PRB, pdsch=(rar_cfg,),
                               pdcch=(PdcchPdu(dci2),), slot=2)
            tx2, _ = gnb_dl_slot(dl2, [tb2],
                                 dci_payloads=[torch.as_tensor(grant2[None], device=tdev)])
            dev.write(2 * S, to_numpy(tx2[0, 0]))
            log(f"[gnb] slot2 msg2 RAR written (tc_rnti=0x{tc_rnti:04X})")

            # ---- slot 3: msg3 PUSCH -------------------------------------
            rx3 = dev.read(3 * S, S)
            m3cfg = _msg3_pusch(msg3_grant, tc_rnti)
            out3 = pusch_rx_grid(m3cfg, re_grid(fp, rx3, 3, tdev), n_iters=12)
            msg3_ok = bool(out3["tb_ok"][0])
            msg3_bytes = tb_to_bytes(to_numpy(out3["tb_bits"][0]), len(MSG3_PAYLOAD))
            log(f"[gnb] slot3 msg3 crc_ok={msg3_ok} payload={msg3_bytes[:20]!r}")
            if not msg3_ok:
                return False

            # ---- slot 4: msg4 contention resolution ---------------------
            # UE Contention Resolution Identity MAC CE: first 48 bits of msg3
            cr_id = msg3_bytes[:6]
            m4cfg = _msg_pdsch(mcs=2, n_prb=12, prb_start=24, rnti=tc_rnti)
            tb4 = torch.as_tensor(bytes_to_tb(cr_id, m4cfg.tbs)[None], device=tdev)
            dci4 = DciConfig(A=DCI_A, aggregation_level=4, rnti=tc_rnti,
                             n_id=CELL_ID, coreset_prb=BWP_PRB)
            grant4 = encode_grant(mcs=2, prb_start=24, n_prb=12)
            dl4 = SlotDlConfig(mu=1, n_bwp_prb=BWP_PRB, pdsch=(m4cfg,),
                               pdcch=(PdcchPdu(dci4),), slot=4)
            tx4, _ = gnb_dl_slot(dl4, [tb4],
                                 dci_payloads=[torch.as_tensor(grant4[None], device=tdev)])
            dev.write(4 * S, to_numpy(tx4[0, 0]))
            log("[gnb] slot4 msg4 contention-resolution written")

            # ---- slot 5: HARQ-ACK on PUCCH F0 ---------------------------
            rx5 = dev.read(5 * S, S)
            grid5 = re_grid(fp, rx5, 5, tdev)
            p0 = _pucch0(tc_rnti)
            tile = grid5[:, :, p0.start_symbol: p0.start_symbol + p0.n_symbols,
                         : 12]
            uci, energy = pucch0_rx(p0, tile)    # uci (B,), energy (B, cands)
            ack = int(uci[0])
            log(f"[gnb] slot5 msg4 HARQ ack={ack} energies="
                f"{to_numpy(energy)[0].round(1).tolist()}")
            ok = (ack == 1)
            log(f"[gnb] RA {'COMPLETE' if ok else 'FAILED'} for "
                f"C-RNTI 0x{tc_rnti:04X}")
    finally:
        dev.close()
    return ok


def run_ue(port: int, host: str = "127.0.0.1", log=print,
           device: str | torch.device = "cuda") -> bool:
    """UE endpoint: sync, PRACH, RAR, msg3, msg4, ACK.  True on C-RNTI."""
    tdev = resolve_device(str(device))
    fp = make_frame_params(1, BWP_PRB)
    S = fp.samples_per_slot(0)
    dev = RfSimDevice.connect(host, port, n_ant=1)
    dev.set_channel(np.array([1.0, 0.12 + 0.05j], np.complex64),
                    noise_sigma=0.01)
    mac = UeMac(RaConfig(preamble_index=PRACH_PREAMBLE))
    try:
        with endpoint_stream(tdev):
            # ---- sync on the slot-0 SSB (CP-aware timing) ----------------
            stream = dev.read(0, S)
            k_off = 12 * SSB_PRB_OFFSET + 120 - 6 * BWP_PRB
            t0, n_id2, metric = pss_search(fp, torch.as_tensor(stream, device=tdev), k_off)
            t0 = int(t0[0])
            # PSS payload starts after the SSB symbol's CP
            sym_off = int(fp.symbol_offsets(0)[SSB_SYMBOL]
                          + fp.cp_lengths(0)[SSB_SYMBOL])
            slot_start = t0 - sym_off
            grid0 = re_grid(fp, stream, 0, tdev)
            sc0 = 12 * SSB_PRB_OFFSET
            tile = grid0[:, :, SSB_SYMBOL: SSB_SYMBOL + 4, sc0: sc0 + 240]
            sss_re = tile[:, 0, 2, 56: 56 + 127]
            n_id1, _ = sss_identify(sss_re, n_id2)
            n_id = int(3 * n_id1[0] + n_id2[0])
            payload, pb_ok = ssb_receive(PbchConfig(n_id=n_id), tile)
            pbch_ok = bool(pb_ok[0])
            log(f"[ue] sync n_id={n_id} slot_start={slot_start} "
                f"pbch_ok={pbch_ok}")
            if n_id != CELL_ID or not pbch_ok:
                return False

            # ---- slot 1: PRACH -------------------------------------------
            mac.start_ra(1, MSG3_PAYLOAD)
            pcfg = _prach_cfg(fp)
            burst = to_numpy(prach_td_tx(pcfg, torch.as_tensor([PRACH_PREAMBLE], device=tdev)))[0]
            sig1 = np.zeros(S, np.complex64)
            sig1[: len(burst)] = burst
            dev.write(slot_start + S, sig1)
            log("[ue] slot1 PRACH preamble sent")

            # ---- slot 2: RAR ---------------------------------------------
            rx2 = dev.read(slot_start + 2 * S, S)
            grid2 = re_grid(fp, rx2, 2, tdev)
            ue_ra = UeConfig(mu=1, n_bwp_prb=BWP_PRB, rnti=RA_RNTI,
                             n_id=CELL_ID, coreset_prb=BWP_PRB)
            out2 = ue_receive_slot(ue_ra, grid2, n_iters=12, slot=2)
            if out2["tb_bits"] is None or not bool(out2["tb_ok"][0]):
                log("[ue] RAR decode failed")
                return False
            rar = unpack_rar(np.unpackbits(np.frombuffer(
                tb_to_bytes(to_numpy(out2["tb_bits"][0]), 8), np.uint8)))
            log(f"[ue] slot2 RAR: preamble={rar['preamble']} ta={rar['ta']} "
                f"tc_rnti=0x{rar['tc_rnti']:04X} grant={rar['mcs']}/"
                f"{rar['prb_start']}/{rar['n_prb']}")
            msg3 = mac.on_rar(2, {"preamble_index": rar["preamble"],
                                  "tc_rnti": rar["tc_rnti"],
                                  "ul_grant": rar, "ta": rar["ta"]})
            if msg3 is None:
                log("[ue] RAR not for our preamble")
                return False

            # ---- slot 3: msg3 PUSCH --------------------------------------
            m3cfg = _msg3_pusch(rar, rar["tc_rnti"])
            tb3 = torch.as_tensor(bytes_to_tb(MSG3_PAYLOAD, m3cfg.tbs)[None], device=tdev)
            tx3, _ = pusch_tx(m3cfg, tb3)
            dev.write(slot_start + 3 * S, to_numpy(tx3[0, 0]))
            log("[ue] slot3 msg3 sent")

            # ---- slot 4: msg4 --------------------------------------------
            rx4 = dev.read(slot_start + 4 * S, S)
            grid4 = re_grid(fp, rx4, 4, tdev)
            ue_tc = UeConfig(mu=1, n_bwp_prb=BWP_PRB, rnti=rar["tc_rnti"],
                             n_id=CELL_ID, coreset_prb=BWP_PRB)
            out4 = ue_receive_slot(ue_tc, grid4, n_iters=12, slot=4)
            if out4["tb_bits"] is None or not bool(out4["tb_ok"][0]):
                log("[ue] msg4 decode failed")
                return False
            cr_echo = tb_to_bytes(to_numpy(out4["tb_bits"][0]), 6)
            crnti = (mac.c_rnti
                     if mac.on_contention_resolution(rar["tc_rnti"], cr_echo)
                     else None)
            log(f"[ue] slot4 contention resolution "
                f"{'OK C-RNTI=0x%04X' % crnti if crnti else 'MISMATCH'}")

            # ---- slot 5: HARQ-ACK ----------------------------------------
            ack = 1 if crnti else 0
            p0 = _pucch0(rar["tc_rnti"])
            tile5 = pucch0_tx(p0, torch.as_tensor([ack], device=tdev))   # (1, syms, 12)
            grid5 = torch.zeros((1, 1, fp.symbols_per_slot, fp.n_sc),
                                dtype=torch.complex64, device=tdev)
            grid5 = place_pucch_tile(grid5, tile5, p0, 0)
            tx5 = ofdm_modulate(fp, map_to_grid(fp, grid5[:, 0]), 5)
            dev.write(slot_start + 5 * S, to_numpy(tx5[0]))
            log("[ue] slot5 HARQ-ACK sent")
        time.sleep(1.5)          # linger so the peer drains the last slot
        return crnti is not None
    finally:
        dev.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description="over-the-air RA over rfsim")
    ap.add_argument("role", choices=["gnb", "ue"])
    ap.add_argument("--port", type=int, default=47001)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.role == "gnb":
        ok = run_gnb(args.port, device=args.device)
        print("RA over-the-air OK" if ok else "RA over-the-air NOK")
    else:
        ok = run_ue(args.port, args.host, device=args.device)
        print("UE RA OK" if ok else "UE RA NOK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
