"""UE receive slot: PDCCH blind decode -> grant -> PDSCH.

Port of openairinterface5g_tpu/models/ue.py (nr-uesoftmodem's
pbch_pdcch_processing / pdsch_processing, executables/nr-ue.c).  The DCI
carries a compact scheduling grant (MCS, PRB allocation, RV) that the UE
parses on the host to configure its PDSCH receiver: the grant is known
only after the blind search, so the receive reads `found` and the DCI bits
back to the host once.  That is the UE slot's one host sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pdcch import blind_search
from .pdsch import PdschConfig
from .pusch import pusch_rx_grid

# the compact DCI "format 1_0-lite" payload (bits, MSB first); bwp = the
# bandwidth-part indicator (a TS 38.212 §7.3.1.1.2 field)
_FIELD_BITS = (("mcs", 5), ("prb_start", 9), ("n_prb", 9), ("rv", 2),
               ("ndi", 1), ("harq_id", 4), ("bwp", 2))
DCI_A = sum(b for _, b in _FIELD_BITS) + 7  # + reserved/padding = 39


def encode_grant(mcs: int, prb_start: int, n_prb: int, rv: int = 0, ndi: int = 1,
                 harq_id: int = 0, bwp: int = 0) -> np.ndarray:
    """A scheduling grant packed into (DCI_A,) int8 bits."""
    vals = {"mcs": mcs, "prb_start": prb_start, "n_prb": n_prb, "rv": rv,
            "ndi": ndi, "harq_id": harq_id, "bwp": bwp}
    bits = []
    for name, nb in _FIELD_BITS:
        bits.extend((vals[name] >> (nb - 1 - i)) & 1 for i in range(nb))
    bits.extend([0] * (DCI_A - len(bits)))
    return np.array(bits, dtype=np.int8)


def decode_grant(bits) -> dict:
    """The fields of a (DCI_A,) grant (numpy or a host tensor)."""
    out, i = {}, 0
    for name, nb in _FIELD_BITS:
        v = 0
        for _ in range(nb):
            v = (v << 1) | int(bits[i])
            i += 1
        out[name] = v
    return out


@dataclasses.dataclass(frozen=True)
class UeConfig:
    mu: int = 1
    n_bwp_prb: int = 48
    rnti: int = 0x1234
    n_id: int = 0
    coreset_prb: int = 48
    coreset_symbol: int = 0
    n_rx: int = 1


def ue_receive_slot(ue: UeConfig, re_grid: torch.Tensor, n_iters: int = 10, slot: int = 0,
                    harq_buffers=None) -> dict:
    """Blind-decode the DCI, configure the PDSCH receiver from the grant, run it.

    re_grid: (B, n_rx, symbols, n_sc_bwp); every trial of the batch carries
    the same grant.  The PdschConfig takes the default decoder.  Returns
    dci_found, grant (None when no DCI was found), al, tb_bits, tb_ok, cfg and
    harq_buffers; harq_buffers in: the previous round's soft buffer of the
    granted HARQ process (the caller keys its store by the grant's harq_id).
    """
    coreset = re_grid[:, :, ue.coreset_symbol, : 12 * ue.coreset_prb]
    dci_bits, found, al = blind_search(coreset, DCI_A, ue.rnti, n_id=ue.n_id, slot=slot,
                                       coreset_prb=ue.coreset_prb)
    # the slot's one host sync: found and the DCI bits in one copy
    host = torch.cat([found[:, None].to(torch.int8), dci_bits], dim=1).cpu().numpy()
    found_np = host[:, 0].astype(bool)
    if not found_np.any():
        return {"dci_found": found, "grant": None, "tb_bits": None,
                "tb_ok": torch.zeros(re_grid.shape[0], dtype=torch.bool, device=re_grid.device)}
    grant = decode_grant(host[int(np.argmax(found_np)), 1:])
    cfg = PdschConfig(mu=ue.mu, n_prb=grant["n_prb"], prb_start=grant["prb_start"],
                      n_bwp_prb=ue.n_bwp_prb, mcs=grant["mcs"], rnti=ue.rnti, n_id=ue.n_id,
                      n_rx=ue.n_rx, start_symbol=2, n_symbols=12, dmrs_symbols=(2,))
    out = pusch_rx_grid(cfg, re_grid, rv=grant["rv"], n_iters=n_iters,
                        harq_buffers=harq_buffers)
    return {"dci_found": found, "grant": grant, "al": al, "tb_bits": out["tb_bits"],
            "tb_ok": out["tb_ok"], "cfg": cfg, "harq_buffers": out["harq_buffers"]}
