"""UE MAC <-> UE PHY interface module (the nr_ue_if_module analog).

The reference UE splits MAC and PHY behind fapi_nr_* request/indication
structs (openair1/PHY/NR_UE_TRANSPORT/../fapi_nr_ue_interface.h +
openair2/NR_UE_PHY_INTERFACE/NR_IF_Module.c): per slot the MAC fills a
dl_config_request (what to search/decode) and an ul_config_request
(what to transmit), and the PHY answers with dl_indication (DCI +
PDSCH data + measurements) and ul time-domain samples.

Here the same seam is a typed boundary the UE softmodem drives: MAC
builds requests from scheduling state, UePhy executes them on RE grids
— so the UE PHY is callable behind the interface rather than
hard-wired into the softmodem loop.

Port of openairinterface5g_tpu/fapi/ue_if.py: the same requests,
indications and PHY calls, with the grid work in torch on the grid's
device (the slot's first tensor; UePhy's `device` for a PRACH-only slot).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch


# --------------------------------------------------------------------------
# Request PDUs (fapi_nr_dl_config_request / fapi_nr_ul_config_request)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DlDciSearch:
    """fapi_nr_dl_config_dci_dl_pdu analog: one blind-decode config."""
    rnti: int
    coreset_prb: int = 48
    coreset_symbol: int = 0
    n_id: int = 0


@dataclasses.dataclass(frozen=True)
class DlSsbSearch:
    """Track the SSB/PBCH of a slot (MIB refresh + measurements)."""
    n_id: int
    prb_offset: int = 0
    start_symbol: int = 2
    i_ssb: int = 0


@dataclasses.dataclass(frozen=True)
class DlConfigRequest:
    slot: int
    dci: tuple = ()              # tuple[DlDciSearch]
    ssb: DlSsbSearch | None = None
    csirs: tuple = ()            # tuple[CsirsConfig]


@dataclasses.dataclass(frozen=True)
class UlPuschPdu:
    cfg: object                  # models.pusch.PuschConfig
    tb_bits: object              # (1, TBS) array


@dataclasses.dataclass(frozen=True)
class UlPucchPdu:
    cfg: object                  # Pucch0Config / Pucch2Config
    uci: object
    prb: int = 0


@dataclasses.dataclass(frozen=True)
class UlPrachPdu:
    cfg: object                  # models.prach.PrachTdConfig
    preamble: int = 0


@dataclasses.dataclass(frozen=True)
class UlConfigRequest:
    slot: int
    pusch: tuple = ()
    pucch: tuple = ()
    prach: tuple = ()


@dataclasses.dataclass
class DlIndication:
    """dl_indication analog: what the PHY found this slot."""
    slot: int
    dci: list = dataclasses.field(default_factory=list)     # decoded grants
    pdsch: list = dataclasses.field(default_factory=list)   # (tb_bits, ok)
    mib: Optional[dict] = None
    csi: list = dataclasses.field(default_factory=list)


class UePhy:
    """UE PHY behind the MAC/PHY seam: executes requests on grids."""

    def __init__(self, mu: int, n_bwp_prb: int, n_rx: int = 1,
                 device: str | torch.device = "cuda"):
        from ..config import make_frame_params
        self.mu = mu
        self.n_bwp_prb = n_bwp_prb
        self.n_rx = n_rx
        self.fp = make_frame_params(mu, n_bwp_prb)
        self.device = torch.device(device)

    def handle_dl(self, req: DlConfigRequest, re_grid) -> DlIndication:
        """Run the slot's DL work list on a (B, n_rx, sym, n_sc) grid."""
        from ..models.ue import DCI_A, UeConfig, decode_grant, ue_receive_slot

        ind = DlIndication(slot=req.slot)
        for d in req.dci:
            ue = UeConfig(mu=self.mu, n_bwp_prb=self.n_bwp_prb, rnti=d.rnti,
                          n_id=d.n_id, coreset_prb=d.coreset_prb,
                          coreset_symbol=d.coreset_symbol, n_rx=self.n_rx)
            out = ue_receive_slot(ue, re_grid, slot=req.slot)
            if out.get("grant") is not None:
                ind.dci.append({"rnti": d.rnti, **out["grant"]})
                ind.pdsch.append((out["tb_bits"], out["tb_ok"]))
        if req.ssb is not None:
            from ..models.pbch import PbchConfig, mib_unpack, ssb_receive
            s = req.ssb
            sc0 = 12 * s.prb_offset
            tile = re_grid[:, :, s.start_symbol: s.start_symbol + 4,
                           sc0: sc0 + 240]
            payload, ok = ssb_receive(
                PbchConfig(n_id=s.n_id, i_ssb=s.i_ssb), tile)
            if bool(ok.all()):
                ind.mib = mib_unpack(payload[0])
        for c in req.csirs:
            from ..models.csirs import csi_measure
            ind.csi.append(csi_measure(c, re_grid[:, :, c.symbol, :]))
        return ind

    def handle_ul(self, req: UlConfigRequest):
        """Compose the slot's UL transmission -> (B, n_ant, samples)."""
        from ..models.gnb import place_pucch_tile
        from ..models.pucch import pucch0_tx, pucch2_tx
        from ..models.pusch import pusch_tx_grid
        from ..phy.ofdm import map_to_grid, ofdm_modulate

        fp = self.fp
        grid_re = None
        for p in req.pusch:
            g, _ = pusch_tx_grid(p.cfg, p.tb_bits)
            grid_re = g if grid_re is None else grid_re + g
        for p in req.pucch:
            from ..models.pucch import Pucch0Config
            tile = (pucch0_tx(p.cfg, p.uci)
                    if isinstance(p.cfg, Pucch0Config)
                    else pucch2_tx(p.cfg, p.uci))
            if grid_re is None:
                B = tile.shape[0]
                grid_re = torch.zeros((B, 1, fp.symbols_per_slot, fp.n_sc),
                                      dtype=torch.complex64, device=tile.device)
            grid_re = place_pucch_tile(grid_re, tile, p.cfg, p.prb)
        tx = None
        if grid_re is not None:
            tx = ofdm_modulate(fp, map_to_grid(fp, grid_re[:, 0]), req.slot)
            tx = tx[:, None] if tx.ndim == 2 else tx
        for p in req.prach:
            from ..models.prach import prach_td_tx
            dev = self.device if tx is None else tx.device
            burst = prach_td_tx(p.cfg, torch.as_tensor([p.preamble], device=dev))
            pad = fp.samples_per_slot(req.slot) - burst.shape[-1]
            sig = torch.nn.functional.pad(burst, (0, max(pad, 0)))[:, None]
            tx = sig if tx is None else tx + sig
        return tx
