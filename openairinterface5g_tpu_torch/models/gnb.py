"""gNB slot: one DL slot composed and transmitted, one UL slot received, from
FAPI-shaped PDUs.

Port of openairinterface5g_tpu/models/gnb.py.  DL (phy_procedures_gNB_TX,
phy_procedures_nr_gNB.c:157, from a DL_TTI.request): every PDU of the slot
is added onto one resource grid, then one OFDM pass.  UL
(phy_procedures_gNB_uespec_RX, :708, from an UL_TTI.request): one OFDM
demodulation, then each PDU's receiver on the shared RE grid; the results
come back as the indication dicts of NR_UL_indication (NR_IF_Module.c:432).
The PUSCH receivers go through pusch_rx_grid, so the fused frontend (K3)
and the configured decoder (K1 with decoder_backend="kernel") run where
they run for a lone PUSCH.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..config import make_frame_params
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from .csirs import CsirsConfig, csirs_tx_grid
from .pbch import PbchConfig, ssb_generate
from .pdcch import DciConfig, pdcch_tx_grid
from .pucch import pucch0_rx, pucch2_rx
from .prach import prach_rx
from .pusch import pusch_rx_grid, pusch_tx_grid


@dataclasses.dataclass(frozen=True)
class SsbPdu:
    cfg: PbchConfig
    prb_offset: int = 0      # lowest PRB of the 20-PRB SSB block
    start_symbol: int = 2    # first symbol in this slot (pbch.ssb_in_slot)


@dataclasses.dataclass(frozen=True)
class PdcchPdu:
    """nfapi_nr_dl_tti_pdcch_pdu: one DCI in a CORESET at prb_start in the BWP."""
    cfg: DciConfig
    prb_start: int = 0


@dataclasses.dataclass(frozen=True)
class CsirsPdu:
    """nfapi_nr_dl_tti_csi_rs_pdu."""
    cfg: CsirsConfig
    prb_start: int = 0


@dataclasses.dataclass(frozen=True)
class SlotDlConfig:
    """DL_TTI.request: what to transmit this slot."""
    mu: int
    n_bwp_prb: int
    pdsch: tuple = ()        # PdschConfig each; their PRB ranges disjoint
    ssb: SsbPdu | tuple | None = None
    pdcch: tuple = ()        # PdcchPdu each; payloads via dci_payloads
    csirs: tuple = ()        # CsirsPdu each
    slot: int = 0


@dataclasses.dataclass(frozen=True)
class SlotUlConfig:
    """UL_TTI.request: what to receive this slot."""
    mu: int
    n_bwp_prb: int
    pusch: tuple = ()        # PuschConfig each
    pucch0: tuple = ()       # (Pucch0Config, prb) each
    pucch2: tuple = ()       # (Pucch2Config, prb_start) each
    prach: tuple = ()        # PrachConfig each (its occasion is passed apart:
                             # rx_nr_prach_ru runs at the RU numerology)
    slot: int = 0


def gnb_dl_slot(dl: SlotDlConfig, tb_payloads: Sequence[torch.Tensor],
                mib_payload=None, dci_payloads: Sequence[torch.Tensor] = (),
                rvs: Sequence[int] = ()):
    """Compose and transmit one DL slot.

    tb_payloads[i]: (B, TBS_i) bits of pdsch[i]; mib_payload: (B, 32), or a
    list with one per SSB PDU; dci_payloads[i]: (B, A_i) bits of pdcch[i];
    rvs[i]: pdsch[i]'s redundancy version (default 0).  Returns (samples
    (B, n_ant, n_samp), each PDSCH's scrambled bits); the device is the
    payloads'.
    """
    if not (dl.pdsch or dl.ssb is not None or dl.pdcch or dl.csirs):
        raise ValueError("an empty DL slot: no PDSCH, SSB, PDCCH or CSI-RS PDU")
    fp = make_frame_params(dl.mu, dl.n_bwp_prb)
    if dl.pdsch:
        ref = tb_payloads[0]
    elif dl.pdcch:
        ref = dci_payloads[0]
    else:
        ref = mib_payload[0] if isinstance(mib_payload, (tuple, list)) else mib_payload
    B, dev = ref.shape[0], ref.device
    n_ant = max([p.n_layers for p in dl.pdsch] or [1])
    grid_re = torch.zeros((B, n_ant, fp.symbols_per_slot, fp.n_sc),
                          dtype=torch.complex64, device=dev)
    debug_bits = []
    for j, (cfg, tb) in enumerate(zip(dl.pdsch, tb_payloads)):
        g, scr = pusch_tx_grid(cfg, tb, rv=rvs[j] if j < len(rvs) else 0)
        grid_re[:, : cfg.n_layers] += g
        debug_bits.append(scr)
    if dl.ssb is not None:
        ssbs = dl.ssb if isinstance(dl.ssb, (tuple, list)) else (dl.ssb,)
        mibs = (mib_payload if isinstance(mib_payload, (tuple, list))
                else [mib_payload] * len(ssbs))
        if len(mibs) != len(ssbs):
            raise ValueError(f"mib_payload list length {len(mibs)} != number of "
                             f"SSB PDUs {len(ssbs)}")
        for pdu, mib in zip(ssbs, mibs):
            tile = ssb_generate(pdu.cfg, mib)               # (B, 4, 240)
            sc0, s0 = 12 * pdu.prb_offset, pdu.start_symbol
            grid_re[:, 0, s0: s0 + 4, sc0: sc0 + 240] += tile
    for pdu, payload in zip(dl.pdcch, dci_payloads):
        row = pdcch_tx_grid(pdu.cfg, payload, dl.slot)      # (B, 12 coreset_prb)
        sc0 = 12 * pdu.prb_start
        grid_re[:, 0, pdu.cfg.start_symbol, sc0: sc0 + row.shape[-1]] += row
    for pdu in dl.csirs:
        width = 12 * pdu.cfg.n_prb
        row = csirs_tx_grid(pdu.cfg, B, width, dev)         # (B, W) or (B, P, W)
        sc0 = 12 * pdu.prb_start
        if row.dim() == 2:
            grid_re[:, 0, pdu.cfg.symbol, sc0: sc0 + width] += row
        else:
            grid_re[:, : row.shape[1], pdu.cfg.symbol, sc0: sc0 + width] += row
    return ofdm_modulate(fp, map_to_grid(fp, grid_re), dl.slot), debug_bits


def _extract_pucch_tile(re_grid: torch.Tensor, cfg, prb: int) -> torch.Tensor:
    """(B, R, n_symbols, 12) PUCCH REs, following intra-slot frequency hopping
    (the first floor(N/2) symbols at `prb`, the rest at second_hop_prb;
    TS 38.211 §6.3.2.4.1)."""
    s0 = cfg.start_symbol
    if not getattr(cfg, "intra_slot_hopping", False):
        sc = 12 * prb
        return re_grid[:, :, s0: s0 + cfg.n_symbols, sc: sc + 12]
    n_first = cfg.n_symbols // 2
    sc1, sc2 = 12 * prb, 12 * cfg.second_hop_prb
    return torch.cat([re_grid[:, :, s0: s0 + n_first, sc1: sc1 + 12],
                      re_grid[:, :, s0 + n_first: s0 + cfg.n_symbols, sc2: sc2 + 12]], dim=2)


def place_pucch_tile(grid_re: torch.Tensor, tile: torch.Tensor, cfg, prb: int) -> torch.Tensor:
    """The inverse of _extract_pucch_tile, for a UE composing its slot: adds
    the (B, n_symbols, 12) tile onto layer 0 of a copy of grid_re (B, L,
    symbols, n_sc) and returns it."""
    out = grid_re.clone()
    s0 = cfg.start_symbol
    if not getattr(cfg, "intra_slot_hopping", False):
        sc = 12 * prb
        out[:, 0, s0: s0 + cfg.n_symbols, sc: sc + 12] += tile
        return out
    n_first = cfg.n_symbols // 2
    sc1, sc2 = 12 * prb, 12 * cfg.second_hop_prb
    out[:, 0, s0: s0 + n_first, sc1: sc1 + 12] += tile[:, :n_first]
    out[:, 0, s0 + n_first: s0 + cfg.n_symbols, sc2: sc2 + 12] += tile[:, n_first:]
    return out


def gnb_ul_slot(ul: SlotUlConfig, rx_samples: torch.Tensor, n_iters: int = 12,
                harq=None, prach_freq=None) -> dict:
    """Receive one UL slot (B, n_rx, n_samp) -> indications: crc_indication
    (per PUSCH PDU tb_ok (B,), cb_ok (B, C)), rx_data (per PUSCH PDU its TB
    bits), uci0 / uci2 (per PUCCH PDU), rach_indication (per PRACH PDU, on
    prach_freq when given) and harq (each PUSCH's new soft buffers)."""
    fp = make_frame_params(ul.mu, ul.n_bwp_prb)
    re_grid = extract_from_grid(fp, ofdm_demodulate(fp, rx_samples, ul.slot))
    crc_ind, rx_data, new_harq = [], [], []
    for j, cfg in enumerate(ul.pusch):
        out = pusch_rx_grid(cfg, re_grid, n_iters=n_iters,
                            harq_buffers=None if harq is None else harq[j])
        crc_ind.append({"tb_ok": out["tb_ok"], "cb_ok": out["cb_ok"]})
        rx_data.append(out["tb_bits"])
        new_harq.append(out["harq_buffers"])
    uci0 = []
    for cfg0, prb in ul.pucch0:
        uci, metric = pucch0_rx(cfg0, _extract_pucch_tile(re_grid, cfg0, prb))
        uci0.append({"uci": uci, "metric": metric})
    uci2 = []
    for cfg2, prb in ul.pucch2:
        sc = 12 * prb
        rx2 = re_grid[:, :, cfg2.start_symbol: cfg2.start_symbol + cfg2.n_symbols,
                      sc: sc + 12 * cfg2.n_prb]
        uci, ok = pucch2_rx(cfg2, rx2)
        uci2.append({"uci": uci, "ok": ok})
    rach = [prach_rx(pcfg, prach_freq) for pcfg in ul.prach] if prach_freq is not None else []
    return {"crc_indication": crc_ind, "rx_data": rx_data, "uci0": uci0, "uci2": uci2,
            "rach_indication": rach, "harq": new_harq}
