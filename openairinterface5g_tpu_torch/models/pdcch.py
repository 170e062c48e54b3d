"""PDCCH / DCI chain: polar-coded DCI + CORESET mapping + blind search.

Port of openairinterface5g_tpu/models/pdcch.py.  DCI coding per TS 38.212
§7.3: 24 ones prepended for the CRC computation, CRC24C scrambled by the
RNTI, polar with IL = 1, E = 108 * AL bits (QPSK; 6 REGs per CCE, 9 data
REs + 3 DMRS per REG).  The CORESET's REG-bundle interleaver and the
search-space hashing (TS 38.213 §10.1) are host functions of the
configuration.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..coding import polar
from ..coding.crc import crc_compute, mask16
from ..phy import refsig
from ..phy.channel_estimation import ls_estimate
from ..phy.llr import llrs as llr_compute
from ..phy.modulation import modulate
from ..phy.scrambling import gold_sequence, scramble_llrs


@dataclasses.dataclass(frozen=True)
class CoresetConfig:
    """CORESET geometry + CCE-to-REG mapping (TS 38.211 §7.3.2.2)."""

    n_prb: int = 48
    duration: int = 1            # CORESET symbols (1..3); grid fns use 1
    interleaved: bool = False
    reg_bundle_size: int = 6     # L in {2, 6} (dur 1) / {duration, 6}
    interleaver_rows: int = 2    # R in {2, 3, 6}
    shift: int = 0               # n_shift (cell id / configured)

    @property
    def n_reg(self) -> int:
        return self.n_prb * self.duration

    @property
    def n_cce(self) -> int:
        return self.n_reg // 6

    def bundle_perm(self) -> np.ndarray:
        """f(x): the REG-bundle interleaver (38.211 7.3.2.2)."""
        L = self.reg_bundle_size if self.interleaved else 6
        n_bun = self.n_reg // L
        if not self.interleaved:
            return np.arange(n_bun)
        R = self.interleaver_rows
        if n_bun % R:
            raise ValueError("C = N_bundle/R must be an integer")
        C = n_bun // R
        f = np.empty(n_bun, dtype=np.int64)
        for x in range(n_bun):
            c, r = divmod(x, R)
            f[x] = (r * C + c + self.shift) % n_bun
        return f

    def cce_prbs(self, cces) -> np.ndarray:
        """Sorted PRB indices occupied by the given CCEs (duration 1)."""
        if self.duration != 1:
            raise ValueError("grid mapping implemented for 1-symbol CORESET")
        L = self.reg_bundle_size if self.interleaved else 6
        f = self.bundle_perm()
        per_cce = 6 // L
        prbs = []
        for cce in cces:
            for b in range(per_cce):
                fb = int(f[cce * per_cce + b])
                prbs.extend(range(fb * L, fb * L + L))  # REG == PRB at dur 1
        return np.array(sorted(prbs), dtype=np.int64)


def search_space_candidates(cs: CoresetConfig, al: int, n_candidates: int,
                            rnti: int = 0, slot: int = 0, css: bool = True,
                            p: int = 0) -> list[int]:
    """Candidate CCE start indices (TS 38.213 §10.1): CSS Y = 0; USS
    Y_{p,slot} by the A_p-multiplicative recursion seeded with the RNTI."""
    n_cce = cs.n_cce
    if css:
        y = 0
    else:
        A = (39827, 39829, 39839)[p % 3]
        D = 65537
        y = rnti
        for _ in range(slot + 1):
            y = (A * y) % D
    return [al * ((y + (m * n_cce) // (al * n_candidates)) % (n_cce // al))
            for m in range(n_candidates)]


@dataclasses.dataclass(frozen=True)
class DciConfig:
    A: int = 39                  # DCI payload bits (format 1_1-ish)
    aggregation_level: int = 4   # 1/2/4/8/16 CCEs
    rnti: int = 0x1234
    n_id: int = 0                # pdcch DMRS scrambling id
    start_symbol: int = 0
    coreset_prb: int = 48        # CORESET width (6 PRB per CCE, 1-symbol)
    coreset: CoresetConfig | None = None  # full geometry (defaults: above)
    cce_index: int = 0           # first CCE of this candidate

    @property
    def cs(self) -> CoresetConfig:
        return self.coreset or CoresetConfig(n_prb=self.coreset_prb)

    @property
    def E(self) -> int:
        return 108 * self.aggregation_level  # 54 QPSK syms/CCE * 2 bits

    @property
    def K(self) -> int:
        return self.A + 24


def _params(cfg: DciConfig):
    return polar.polar_params(K=cfg.K, E=cfg.E, n_max=9, i_il=True)


def _dci_crc(payload: torch.Tensor, rnti: int) -> torch.Tensor:
    """CRC24C over (24 ones ++ payload), its last 16 bits XOR the RNTI."""
    ones = torch.ones((*payload.shape[:-1], 24), dtype=torch.int8, device=payload.device)
    crc = crc_compute(torch.cat([ones, payload.to(torch.int8)], dim=-1), "24C")
    return torch.cat([crc[..., :8], crc[..., 8:] ^ mask16(rnti, payload.device)], dim=-1)


def dci_encode(cfg: DciConfig, payload: torch.Tensor) -> torch.Tensor:
    """(B, A) DCI bits -> (B, E) coded bits (TS 38.212 §7.3.2)."""
    k_bits = torch.cat([payload.to(torch.int8), _dci_crc(payload, cfg.rnti)], dim=-1)
    return polar.encode(_params(cfg), k_bits)


def dci_decode(cfg: DciConfig, llr_e: torch.Tensor, list_size: int = 8):
    """(B, E) LLRs -> ((B, A) payload, ok (B,)): CA-SCL with the RNTI-masked
    CRC."""
    p = _params(cfg)
    cands, _ = polar.scl_decode(p, polar.rate_recover_llr(p, llr_e), list_size)
    payload, rx_crc = cands[..., :-24], cands[..., -24:]
    ok = torch.all(_dci_crc(payload, cfg.rnti) == rx_crc, dim=-1)
    return polar.select_path(payload, ok)


# --- CORESET RE mapping (1-symbol; interleaved or not) ----------------------

def _pdcch_positions(cfg: DciConfig):
    """Data + DMRS subcarrier indices within the CORESET for this
    candidate's CCEs (cce_index .. cce_index+AL-1), after the CCE-to-REG
    (bundle-interleaved) mapping.  REG = 1 PRB x 1 symbol; DMRS on SCs
    1, 5, 9 of each PRB (38.211 7.4.1.3)."""
    prbs = cfg.cs.cce_prbs(range(cfg.cce_index, cfg.cce_index + cfg.aggregation_level))
    sc = (prbs[:, None] * 12 + np.arange(12)[None, :]).reshape(-1)
    return sc[sc % 4 != 1].astype(np.int32), sc[sc % 4 == 1].astype(np.int32), len(prbs)


@functools.lru_cache(maxsize=64)
def _consts(cfg: DciConfig, slot: int, device: torch.device):
    """A candidate's constants on `device`: data SCs, DMRS SCs, its pilots
    (the CORESET-wide Gold sequence, element k//4 at DMRS subcarrier k),
    and the interpolation of each data SC between the bracketing pilots of
    its PRB (lo, hi, weight)."""
    data_sc, dmrs_sc, _ = _pdcch_positions(cfg)
    pil_full = refsig.dmrs_sequence_np(refsig.dmrs_cinit(slot, cfg.start_symbol, cfg.n_id),
                                       3 * cfg.cs.n_prb)
    # pilots at SCs +1/+5/+9 of each PRB; the edge SCs hold
    prb_pos = {p: i for i, p in enumerate(sorted(set(data_sc // 12)))}
    lo = np.empty(len(data_sc), np.int64)
    hi = np.empty(len(data_sc), np.int64)
    w = np.empty(len(data_sc), np.float32)
    for i, d in enumerate(data_sc):
        base = 3 * prb_pos[d // 12]
        k = d % 12
        if k <= 1:
            lo[i] = hi[i] = base
            w[i] = 0.0
        elif k >= 9:
            lo[i] = hi[i] = base + 2
            w[i] = 0.0
        else:
            j = (k - 1) // 4             # bracketing pilot pair (1,5)/(5,9)
            lo[i], hi[i] = base + j, base + j + 1
            w[i] = ((k - 1) % 4) / 4.0

    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (on(data_sc, torch.long), on(dmrs_sc, torch.long), on(pil_full[dmrs_sc // 4]),
            on(lo), on(hi), on(w))


def _cinit(cfg: DciConfig) -> int:
    """Codeword scrambling cinit (38.211 7.3.2.3)."""
    return ((cfg.rnti << 16) + cfg.n_id) % (1 << 31)


def pdcch_tx_grid(cfg: DciConfig, payload: torch.Tensor, slot: int = 0) -> torch.Tensor:
    """(B, A) DCI -> (B, 12*coreset_prb) REs of the CORESET symbol."""
    B, dev = payload.shape[0], payload.device
    bits = dci_encode(cfg, payload)
    syms = modulate(bits ^ gold_sequence(_cinit(cfg), cfg.E, dev), 2)
    data_sc, dmrs_sc, pil = _consts(cfg, slot, dev)[:3]
    out = torch.zeros((B, 12 * cfg.cs.n_prb), dtype=torch.complex64, device=dev)
    out[:, data_sc] = syms
    out[:, dmrs_sc] = pil
    return out


def pdcch_rx(cfg: DciConfig, rx_res: torch.Tensor, slot: int = 0, list_size: int = 8):
    """(B, n_rx, 12*coreset_prb) CORESET symbol REs -> DCI decode: LS
    estimate at the PDCCH DMRS, linear interpolation between the bracketing
    pilots of each PRB, MRC, QPSK LLRs, descramble, SCL."""
    data_sc, dmrs_sc, pil, lo, hi, w = _consts(cfg, slot, rx_res.device)
    hp = ls_estimate(rx_res[..., dmrs_sc], pil)
    h = (1.0 - w) * hp[..., lo] + w * hp[..., hi]
    yd = rx_res[..., data_sc]
    x = torch.sum(torch.conj(h) * yd, dim=1)
    mag = torch.sum(h.abs() ** 2, dim=1)
    llr = scramble_llrs(llr_compute(x, mag, 2), _cinit(cfg))
    return dci_decode(cfg, llr, list_size=list_size)


def blind_search(rx_res: torch.Tensor, A: int, rnti: int,
                 aggregation_levels=(1, 2, 4, 8), n_id: int = 0,
                 coreset_prb: int = 48, slot: int = 0, list_size: int = 8,
                 coreset: CoresetConfig | None = None,
                 candidates_per_al=(6, 6, 2, 2), css: bool = True,
                 start_symbol: int = 0):
    """UE-side DCI blind decode over (AL, candidate) hypotheses: for each
    aggregation level, the search-space candidates (CSS Y = 0 or USS hashed
    by the RNTI); the first CRC-passing payload wins.  The RNTI-masked CRC
    is the detector.  Returns (payload (B, A), found (B,), al (B,))."""
    cs = coreset or CoresetConfig(n_prb=coreset_prb)
    B, dev = rx_res.shape[0], rx_res.device
    best_payload = torch.zeros((B, A), dtype=torch.int8, device=dev)
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    al_out = torch.zeros((B,), dtype=torch.int32, device=dev)
    for ai, al in enumerate(aggregation_levels):
        if 6 * al > cs.n_reg:
            continue
        n_cand = candidates_per_al[ai] if ai < len(candidates_per_al) else 1
        n_cand = min(n_cand, cs.n_cce // al)
        tried = set()
        for cce0 in search_space_candidates(cs, al, n_cand, rnti=rnti, slot=slot, css=css):
            if cce0 in tried:
                continue
            tried.add(cce0)
            cfg = DciConfig(A=A, aggregation_level=al, rnti=rnti, n_id=n_id, coreset=cs,
                            cce_index=cce0, start_symbol=start_symbol)
            bits, ok = pdcch_rx(cfg, rx_res, slot=slot, list_size=list_size)
            take = ok & ~found
            best_payload = torch.where(take[:, None], bits, best_payload)
            al_out = torch.where(take, al, al_out)
            found = found | ok
    return best_payload, found, al_out
