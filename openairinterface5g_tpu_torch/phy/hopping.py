"""Group and sequence hopping of low-PAPR sequences (TS 38.211 §6.3.2.2.1,
§6.4.1.1.1.2 transform-precoded PUSCH DMRS).

Port of openairinterface5g_tpu/phy/hopping.py.  The (u, v) pair is a host
function of (hopping configuration, slot, hop), so a configuration's pilots
stay host constants.

Modes: 'neither' (f_gh = 0, v = 0), 'enable' (group hopping: f_gh from
Gold bits per slot and hop, v = 0), 'disable' (sequence hopping: f_gh = 0,
v one Gold bit per slot and hop, only for sequences of 6 PRB or more).
"""
from __future__ import annotations

import numpy as np

from .scrambling import gold_sequence_np


# The JAX package's bit-serial Gold helper of this name (models/pucch.py reads
# it); here it is the same sequence from the packed generator.
_gold_bits_host = gold_sequence_np


def group_sequence_uv(hopping_id: int, mode: str, slot: int, hop: int = 0,
                      m_zc: int = 12, symbols_per_slot: int = 14) -> tuple[int, int]:
    """-> (u, v) of the low-PAPR sequence of (slot, intra-slot hop).

    u = (f_gh + f_ss) mod 30 with f_ss = hopping_id mod 30; group hopping
    draws 8 Gold bits per hop index n = 2*slot + hop, seeded
    floor(hopping_id / 30); sequence hopping draws one bit per hop (v), only
    for M_ZC >= 6*12 subcarriers.
    """
    f_ss = hopping_id % 30
    if mode == "neither":
        return f_ss, 0
    n_hop = 2 * slot + hop
    if mode == "enable":
        c = gold_sequence_np(hopping_id // 30, 8 * (n_hop + 1))
        seg = c[8 * n_hop: 8 * n_hop + 8].astype(np.int64)
        f_gh = int((seg * (1 << np.arange(8))).sum() % 30)
        return (f_gh + f_ss) % 30, 0
    if mode == "disable":
        v = 0
        if m_zc >= 6 * 12:
            c = gold_sequence_np((hopping_id // 30 << 5) + f_ss, n_hop + 1)
            v = int(c[n_hop])
        return f_ss, v
    raise ValueError(f"unknown hopping mode {mode!r}")
