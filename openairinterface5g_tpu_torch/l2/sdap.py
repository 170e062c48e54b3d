"""SDAP (TS 37.324): QoS-flow <-> DRB mapping (openair2/SDAP analog).

A copy of openairinterface5g_tpu/l2/sdap.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class SdapConfig:
    default_drb: int = 1
    dl_header: bool = False       # presence of SDAP header (RRC-configured)
    ul_header: bool = False


class SdapEntity:
    """Maps QFI -> DRB on TX, strips/parses headers on RX."""

    def __init__(self, cfg: SdapConfig, send_to_drb: Callable[[int, bytes], None],
                 deliver: Callable[[int, bytes], None]):
        self.cfg = cfg
        self.qfi_to_drb: dict[int, int] = {}
        self.send_to_drb = send_to_drb
        self.deliver = deliver

    def map_flow(self, qfi: int, drb: int):
        self.qfi_to_drb[qfi] = drb

    def sdu_in(self, qfi: int, data: bytes):
        """DL data in (from GTP-U / upper layer) -> DRB."""
        drb = self.qfi_to_drb.get(qfi, self.cfg.default_drb)
        if self.cfg.dl_header:
            data = bytes([0x80 | (qfi & 0x3F)]) + data   # RDI=0,RQI=0,QFI
        self.send_to_drb(drb, data)

    def pdu_in(self, drb: int, data: bytes):
        """UL data from a DRB -> (qfi, sdu) upward."""
        if self.cfg.ul_header:
            qfi = data[0] & 0x3F
            self.deliver(qfi, data[1:])
        else:
            # reverse lookup: first flow mapped to this DRB (or 0)
            qfi = next((q for q, d in self.qfi_to_drb.items() if d == drb), 0)
            self.deliver(qfi, data)
