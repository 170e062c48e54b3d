"""UCI-on-PUSCH multiplexing (TS 38.212 §6.2.7 / §6.3.2.4).

Port of openairinterface5g_tpu/models/uci_on_pusch.py.  HARQ-ACK, CSI
part 1 and CSI part 2 are coded on their own (small block <= 11 bits, CRC +
polar otherwise: models/pucch.py's uci_encode / uci_decode), then written
into the G-bit PUSCH codeword at distributed RE positions fixed by the
configuration:

* each UCI stream takes n REs per symbol spaced d = floor(free/n) apart,
  from the first symbol after the first DMRS symbol for the ACK and from
  the first data symbol for CSI;
* O_ack <= 2 punctures: the data maps everywhere and the ACK overwrites
  (CSI part 1 avoids the ACK's candidate REs); O_ack > 2 and CSI are
  rate-matched: the data codeword shrinks to G_data = G - G_ack - G_csi1 -
  G_csi2;
* the capacity Q' per stream follows 38.212 6.3.2.4.1.1.

The multiplexed sequence is scrambled and modulated with the data (same Qm).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .pucch import uci_decode, uci_encode
from .pusch import PuschConfig


def _crc_len(O: int) -> int:
    return 0 if O <= 11 else (6 if O < 20 else 11)


@dataclasses.dataclass(frozen=True)
class UciOnPuschConfig:
    n_ack_bits: int = 2
    n_csi1_bits: int = 0
    n_csi2_bits: int = 0
    beta_ack: float = 2.0
    beta_csi1: float = 2.0
    beta_csi2: float = 2.0
    alpha: float = 0.5           # scaling cap (higher-layer 'scaling')

    @property
    def ack_punctures(self) -> bool:
        return self.n_ack_bits <= 2

    def _q_prime(self, cfg: PuschConfig, O: int, beta: float, cap_re: int) -> int:
        """REs per layer of a stream (38.212 6.3.2.4.1.1): the denominator
        is sum_r K_r over the UL-SCH code blocks."""
        if O == 0:
            return 0
        p, _ = cfg.seg_params()
        m_uci = cfg.n_data_re
        q = int(np.ceil((O + _crc_len(O)) * beta * m_uci / (p.C * p.K)))
        q = min(q, int(np.ceil(self.alpha * m_uci)), cap_re)
        return max(q, 1)

    def g_sizes(self, cfg: PuschConfig) -> tuple[int, int, int, int]:
        """(G_ack, G_csi1, G_csi2, G_data) in bits."""
        a, c1, c2, _, _, _ = _build_map(cfg, self)
        per_re = cfg.n_layers * cfg.qm_rate[0]
        g_ack, g_csi1, g_csi2 = len(a) * per_re, len(c1) * per_re, len(c2) * per_re
        g_data = cfg.G - g_csi1 - g_csi2 - (0 if self.ack_punctures else g_ack)
        return g_ack, g_csi1, g_csi2, g_data


@functools.lru_cache(maxsize=64)
def _build_map(cfg: PuschConfig, ucfg: UciOnPuschConfig):
    """The distributed-RE selection.  Returns flat data-RE indices (index =
    data symbol position * M + subcarrier) of the ACK, CSI-1 and CSI-2, the
    data REs' order (without the rate-matched UCI REs), and the ACK's
    positions within the data order and within CSI-2 (puncturing)."""
    M = 12 * cfg.n_prb
    data_syms = list(cfg.data_symbols)
    S = len(data_syms)
    free = {si: list(range(M)) for si in range(S)}
    first_after_dmrs = next((si for si, s in enumerate(data_syms) if s > cfg.dmrs_symbols[0]), 0)

    def select(start_si: int, n_re: int, avoid: set[int] | None = None):
        chosen: list[int] = []
        for si in list(range(start_si, S)) + list(range(0, start_si)):
            if n_re <= 0:
                break
            f = [m for m in free[si] if avoid is None or (si * M + m) not in avoid]
            if not f:
                continue
            take = min(len(f), n_re)
            d = len(f) // take
            for m in [f[j * d] for j in range(take)]:
                free[si].remove(m)
                chosen.append(si * M + m)
            n_re -= take
        return chosen

    # ACK candidate REs: for <= 2 bits 'reserved' (CSI-1 avoids them, data
    # still maps there); for > 2 bits taken outright
    q_ack = ucfg._q_prime(cfg, ucfg.n_ack_bits, ucfg.beta_ack, cap_re=cfg.n_data_re // 2)
    if ucfg.ack_punctures:
        snapshot = {k: list(v) for k, v in free.items()}
        ack_res = select(first_after_dmrs, q_ack)
        free = snapshot
    else:
        ack_res = select(first_after_dmrs, q_ack)
    cap = cfg.n_data_re - (0 if ucfg.ack_punctures else len(ack_res))
    q_csi1 = ucfg._q_prime(cfg, ucfg.n_csi1_bits, ucfg.beta_csi1, cap_re=cap // 2)
    csi1_res = select(0, q_csi1, avoid=set(ack_res)) if ucfg.n_csi1_bits else []
    cap -= len(csi1_res)
    q_csi2 = ucfg._q_prime(cfg, ucfg.n_csi2_bits, ucfg.beta_csi2, cap_re=cap // 2)
    # CSI part 2 may land on reserved ACK REs: the ACK (<= 2 bits) then
    # punctures CSI part 2 there (38.212 6.2.7; the demux zeroes those LLRs)
    csi2_res = select(0, q_csi2) if ucfg.n_csi2_bits else []

    taken = set(csi1_res) | set(csi2_res)
    if not ucfg.ack_punctures:
        taken |= set(ack_res)
    data_res = [si * M + m for si in range(S) for m in range(M) if (si * M + m) not in taken]
    pos_of = {re: i for i, re in enumerate(data_res)}
    csi2_pos = {re: i for i, re in enumerate(csi2_res)}
    ack_in_data, ack_in_csi2 = [], []
    if ucfg.ack_punctures:
        for re in ack_res:
            if re in csi2_pos:
                ack_in_csi2.append(csi2_pos[re])
            else:
                ack_in_data.append(pos_of[re])
    return (np.array(ack_res, np.int64), np.array(csi1_res, np.int64),
            np.array(csi2_res, np.int64), np.array(data_res, np.int64),
            np.array(ack_in_data, np.int64), np.array(ack_in_csi2, np.int64))


def _bit_idx(res: np.ndarray, per_re: int) -> np.ndarray:
    """RE indices -> codeword bit indices ((s*M+m)*L*Qm + 0..L*Qm-1)."""
    return (res[:, None] * per_re + np.arange(per_re)[None, :]).reshape(-1)


@functools.lru_cache(maxsize=64)
def _bit_maps(cfg: PuschConfig, ucfg: UciOnPuschConfig, device: torch.device) -> dict:
    """_build_map's REs as codeword bit indices on `device`: 'ack', 'csi1',
    'csi2', 'data', 'ack_in_data', 'ack_in_csi2'."""
    per_re = cfg.n_layers * cfg.qm_rate[0]
    names = ("ack", "csi1", "csi2", "data", "ack_in_data", "ack_in_csi2")
    return {n: torch.as_tensor(_bit_idx(res, per_re), device=device)
            for n, res in zip(names, _build_map(cfg, ucfg))}


def mux_uci_bits(cfg: PuschConfig, ucfg: UciOnPuschConfig, data_cw: torch.Tensor,
                 ack_bits=None, csi1_bits=None, csi2_bits=None) -> torch.Tensor:
    """Data codeword (B, G_data) + UCI payloads -> (B, G) multiplexed bits
    (CSI-1, then CSI-2, then the ACK written last)."""
    idx = _bit_maps(cfg, ucfg, data_cw.device)
    out = torch.zeros((data_cw.shape[0], cfg.G), dtype=torch.int8, device=data_cw.device)
    out[:, idx["data"]] = data_cw.to(torch.int8)
    for name, bits, O in (("csi1", csi1_bits, ucfg.n_csi1_bits),
                          ("csi2", csi2_bits, ucfg.n_csi2_bits),
                          ("ack", ack_bits, ucfg.n_ack_bits)):
        if O and len(idx[name]):
            out[:, idx[name]] = uci_encode(O, len(idx[name]), bits)
    return out


def demux_uci_llrs(cfg: PuschConfig, ucfg: UciOnPuschConfig, llr_cw: torch.Tensor) -> dict:
    """(B, G) descrambled LLRs -> dict of the streams' LLRs and the data
    LLRs.  The data LLRs are zero at the punctured ACK positions (erasures
    for the LDPC decoder), as are the CSI-2 LLRs where the ACK punctured
    them (38.212 6.2.7)."""
    idx = _bit_maps(cfg, ucfg, llr_cw.device)
    out = {}
    if len(idx["ack"]):
        out["ack"] = llr_cw[:, idx["ack"]]
    if len(idx["csi1"]):
        out["csi1"] = llr_cw[:, idx["csi1"]]
    if len(idx["csi2"]):
        csi2 = llr_cw[:, idx["csi2"]]
        if len(idx["ack_in_csi2"]):
            csi2[:, idx["ack_in_csi2"]] = 0.0
        out["csi2"] = csi2
    data = llr_cw[:, idx["data"]]
    if len(idx["ack_in_data"]):
        data[:, idx["ack_in_data"]] = 0.0
    out["data"] = data
    return out


def decode_uci(cfg: PuschConfig, ucfg: UciOnPuschConfig, streams: dict) -> dict:
    """Decode the UCI streams of demux_uci_llrs: '<name>' bits and
    '<name>_ok' per stream present."""
    res = {}
    for name, O in (("ack", ucfg.n_ack_bits), ("csi1", ucfg.n_csi1_bits),
                    ("csi2", ucfg.n_csi2_bits)):
        if O and name in streams:
            res[name], res[name + "_ok"] = uci_decode(O, streams[name].shape[-1], streams[name])
    return res
