"""PUSCH end-to-end chain: UE TX -> gNB RX.

Port of openairinterface5g_tpu/models/pusch.py, CP-OFDM and DFT-s-OFDM:

  TX: CRC -> segmentation -> LDPC encode -> rate match -> scramble ->
      modulate -> [DFT spread] -> layer map -> RE map (data, PTRS, DMRS)
      -> IFFT
  RX: FFT -> [fused frontend kernel | channel estimation -> MRC/MMSE/ZF
      or 2-layer ML -> PTRS phase tracking -> LLR -> descramble] -> rate
      recovery -> LDPC decode -> CRC

Tensors keep the JAX package's layouts: (B, n_rx, symbols, n_sc_bwp) RE
grids, (B, qm, G/qm) bit planes, a (B, C, cols*Z) mother-code buffer.  The
slot batch is the leading dimension.  A rectangular allocation is written
and read as symbol blocks; PTRS holes, data on the free comb of the DMRS
symbols and rate-match patterns take the RE map (``data_re_map``), built
once per configuration and kept on the device with the configuration's
other constants (``_consts``).  UCI on PUSCH (``uci_cfg``, models/
uci_on_pusch.py) multiplexes HARQ-ACK and CSI into the codeword; its
receiver cuts the streams from pusch_frontend's codeword-order LLRs (the
fused frontend where it runs), then takes the batched LDPC decode.
``decoder_first_iters`` raises NotImplementedError naming its ROADMAP.md
entry.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..coding import ldpc, rate_matching, segmentation
from ..coding.backend import decoder as ldpc_decoder
from ..coding.crc import CRC_POLYS, crc_attach, crc_ok
from ..config import FrameParams, make_frame_params
from ..ops import pusch_frontend as fe
from ..phy import channel_estimation as ce
from ..phy import equalization as eq
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy import refsig
from ..phy import transform_precoding as tp
from ..phy.hopping import group_sequence_uv
from ..phy.ml_detector import ml_llrs_2layer
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from ..phy.scrambling import pusch_cinit, scramble, scramble_llrs
from ..transport import compute_tbs, mcs_to_qm_rate
from ..utils import profiling

_DECODER_BACKENDS = ("reference", "kernel")
_FRONTEND_BACKENDS = ("auto", "reference", "kernel")


@dataclasses.dataclass(frozen=True)
class PuschConfig:
    mu: int = 1
    n_prb: int = 106
    mcs: int = 9
    mcs_table: int = 1
    n_layers: int = 1
    n_rx: int = 1
    start_symbol: int = 0
    n_symbols: int = 14
    dmrs_symbols: tuple = (2,)       # type A, pos 2, single-symbol DMRS
    rnti: int = 0x1234
    n_id: int = 0
    slot: int = 0
    transform_precoding: bool = False
    group_seq_hopping: str = "neither"
    prb_start: int = 0               # allocation offset within the BWP
    n_bwp_prb: int | None = None     # carrier/BWP width (defaults to n_prb)
    decoder_backend: str = "reference"   # 'reference' | 'kernel' (coding/backend.py)
    frontend_backend: str = "auto"   # 'auto' | 'reference' | 'kernel': the fused
                                     # frontend kernel (ops/pusch_frontend.py);
                                     # auto = the kernel for CUDA tensors when
                                     # supported(cfg), the unfused chain otherwise
    decoder_first_iters: int = 0     # two-phase decode: not carried into the port
    decoder_check_every: int = 0     # > 0: per-code-block early stop every N
                                     # iterations (ops/ldpc_decoder.py)
    llr_quant_bits: int = 0          # 0 = float; 8 = int8 reference parity
    chest_window: int = 8            # pilot smoothing window
    chest_mode: str = "window"       # 'window' | 'delay' (delay-domain denoise)
    ptrs: bool = False               # phase-tracking RS (TS 38.211 §6.4.1.2)
    ptrs_k: int = 2                  # K_PTRS: one subcarrier every K PRBs
    ptrs_l: int = 1                  # L_PTRS time density (1/2/4)
    ptrs_re_offset: int = 0
    dmrs_max_len: int = 1            # 2 = double-symbol DMRS (ports 0..7);
                                     # dmrs_symbols then lists consecutive pairs
    dmrs_port0: int = 0              # first DMRS port
    cdm_groups_no_data: int = 2      # 2 = DMRS symbols carry no data; 1 = data
                                     # on the odd comb of each DMRS symbol
    scrambling_q: int = 0            # codeword index q
    tbs_lbrm: int | None = None      # LBRM reference TBS (38.212 5.4.2.1)
    receiver: str = "linear"         # 'linear' (MRC/MMSE/ZF) | 'ml' (2-layer
                                     # joint max-log, phy/ml_detector.py)
    rm_res: tuple = ()               # rate-match pattern: ((symbol, sc), ...)
                                     # REs taken from data, sc relative to the
                                     # allocation start (e.g. a CSI-RS)

    def __post_init__(self):
        if self.decoder_backend not in _DECODER_BACKENDS:
            raise ValueError(f"decoder_backend {self.decoder_backend!r}; "
                             f"have {_DECODER_BACKENDS}")
        if self.frontend_backend not in _FRONTEND_BACKENDS:
            raise ValueError(f"frontend_backend {self.frontend_backend!r}; "
                             f"have {_FRONTEND_BACKENDS}")

    @property
    def bwp_prbs(self) -> int:
        return self.n_bwp_prb if self.n_bwp_prb is not None else self.n_prb

    @property
    def sc0(self) -> int:
        """First subcarrier of the allocation within the BWP grid."""
        return 12 * self.prb_start

    @property
    def fp(self) -> FrameParams:
        return make_frame_params(self.mu, self.bwp_prbs)

    @property
    def qm_rate(self):
        return mcs_to_qm_rate(self.mcs, self.mcs_table)

    @property
    def data_symbols(self) -> tuple:
        return tuple(s for s in range(self.start_symbol, self.start_symbol + self.n_symbols)
                     if s not in self.dmrs_symbols)

    @property
    def ptrs_symbol_flags(self) -> tuple:
        """Per data symbol: carries PTRS.  Every L_PTRS symbols, the counter
        restarting at each DMRS symbol (TS 38.211 Table 6.4.1.2.2.1-1)."""
        if not self.ptrs:
            return tuple(False for _ in self.data_symbols)
        flags = []
        l_ref = self.start_symbol
        for s in range(self.start_symbol, self.start_symbol + self.n_symbols):
            if s in self.dmrs_symbols:
                l_ref = s
                continue
            flags.append((s - l_ref) % self.ptrs_l == 0)
        return tuple(flags)

    def ptrs_rel_sc(self) -> np.ndarray:
        """PTRS subcarriers relative to the allocation start."""
        return refsig.ptrs_sc_indices(self.n_prb, self.ptrs_k, self.ptrs_re_offset)

    @property
    def uses_re_map(self) -> bool:
        """True when data REs are not a rectangle (PTRS holes, data on the
        free comb of DMRS symbols, or a rate-match pattern)."""
        return self.ptrs or self.cdm_groups_no_data == 1 or bool(self.rm_res)

    def data_re_map(self) -> tuple[np.ndarray, np.ndarray]:
        """(symbol_ids, sc_ids) int64 of the data REs in mapping order
        (symbol, then subcarrier), sc relative to the allocation start:
        without the PTRS REs (data is rate-matched around them, TS 38.211
        §6.4.1.2.2) and the rm_res REs, and with cdm_groups_no_data == 1 with
        the odd (CDM group 1) comb of each DMRS symbol."""
        return _data_re_map(self)

    @property
    def n_data_re(self) -> int:
        """Data REs in the slot (with the free comb of the DMRS symbols when
        one CDM group is reserved, without PTRS and rm_res REs)."""
        if self.rm_res:
            return len(self.data_re_map()[0])
        n = len(self.data_symbols) * 12 * self.n_prb
        if self.ptrs:
            n -= sum(self.ptrs_symbol_flags) * len(self.ptrs_rel_sc())
        if self.cdm_groups_no_data == 1:
            n += len(self.dmrs_symbols) * 6 * self.n_prb
        return n

    @property
    def tbs(self) -> int:
        qm, r = self.qm_rate
        dmrs_per_prb = 12 if self.cdm_groups_no_data == 2 else 6
        return compute_tbs(qm, r * 1024, self.n_prb, self.n_symbols,
                           dmrs_per_prb * len(self.dmrs_symbols), 0, self.n_layers)

    @property
    def G(self) -> int:
        return self.n_data_re * self.qm_rate[0] * self.n_layers

    def seg_params(self):
        A = self.tbs
        crc_name = "24A" if A > 3824 else "16"
        L = 24 if A > 3824 else 16
        bg = segmentation.base_graph_select(A, self.qm_rate[1])
        return segmentation.segment_params(A + L, bg), crc_name

    def ncb(self) -> int | None:
        """Limited circular-buffer size (LBRM, TS 38.212 §5.4.2.1) or None,
        rounded down to a multiple of Z."""
        if self.tbs_lbrm is None:
            return None
        p, _ = self.seg_params()
        n_ref = (3 * self.tbs_lbrm) // (2 * p.C)
        n_full = (66 if p.bg == 1 else 50) * p.Z
        return min(n_full, (n_ref // p.Z) * p.Z)

    def dmrs_pilot_np(self, symbol: int) -> np.ndarray:
        """(6*n_prb,) DMRS pilots of a DMRS symbol (host constant): CP-OFDM,
        Gold-seeded QPSK (TS 38.211 §6.4.1.1.1.1); transform precoding, the
        low-PAPR sequence r_{u,v} with group or sequence hopping
        (§6.4.1.1.1.2)."""
        if not self.transform_precoding:
            cinit = refsig.dmrs_cinit(self.slot, symbol, self.n_id)
            return refsig.dmrs_sequence_np(cinit, 6 * self.n_prb)
        u, v = group_sequence_uv(self.n_id, self.group_seq_hopping, self.slot,
                                 hop=0, m_zc=6 * self.n_prb)
        return refsig.low_papr_sequence(u, v, 6 * self.n_prb)

    def cb_e_sizes(self, g_total: int | None = None) -> list[int]:
        """Per-code-block rate-matched lengths E_j (TS 38.212 §5.4.2.1)."""
        p, _ = self.seg_params()
        qm = self.qm_rate[0]
        C, Nl = p.C, self.n_layers
        gp = (self.G if g_total is None else g_total) // (Nl * qm)
        gamma = gp % C
        return [Nl * qm * (gp // C) if j <= C - 1 - gamma else Nl * qm * (-(-gp // C))
                for j in range(C)]


def _check_ported(cfg: PuschConfig) -> None:
    """Raise for the JAX model's branches that this port does not run."""
    if cfg.decoder_first_iters:
        raise NotImplementedError(
            "decoder_first_iters (two-phase decode) is not carried into the port: "
            "ROADMAP.md 'Not carried into the port'")


def _check_branches(cfg: PuschConfig, uci_cfg=None) -> None:
    """The combinations the JAX model asserts against."""
    if uci_cfg is not None and cfg.uses_re_map:
        raise ValueError("UCI on PUSCH is not combined with the RE map (PTRS, data "
                         "on DMRS symbols or rm_res)")
    if cfg.transform_precoding and (cfg.n_layers != 1 or cfg.uses_re_map):
        raise ValueError("transform precoding takes one layer and a rectangular "
                         "allocation (no PTRS, data on DMRS symbols or rm_res)")
    if cfg.receiver == "ml" and (cfg.n_layers != 2 or cfg.uses_re_map
                                 or cfg.transform_precoding):
        raise ValueError("receiver='ml' is the 2-layer rectangular PUSCH")


@functools.lru_cache(maxsize=64)
def _data_re_map(cfg: PuschConfig) -> tuple[np.ndarray, np.ndarray]:
    """PuschConfig.data_re_map: a mask of the slot's allocation, read in
    row-major (symbol, subcarrier) order."""
    M = 12 * cfg.n_prb
    mask = np.zeros((cfg.start_symbol + cfg.n_symbols, M), bool)
    flags = dict(zip(cfg.data_symbols, cfg.ptrs_symbol_flags))
    ptrs_sc = cfg.ptrs_rel_sc() if cfg.ptrs else np.zeros(0, np.int32)
    for s in range(cfg.start_symbol, cfg.start_symbol + cfg.n_symbols):
        if s in cfg.dmrs_symbols:
            if cfg.cdm_groups_no_data == 1:
                mask[s, 1::2] = True
            continue
        mask[s] = True
        if flags[s]:
            mask[s, ptrs_sc[ptrs_sc < M]] = False
    for s, m in cfg.rm_res:
        if 0 <= s < mask.shape[0] and 0 <= m < M:
            mask[s, m] = False
    sym_ids, sc_ids = np.nonzero(mask)
    return sym_ids.astype(np.int64), sc_ids.astype(np.int64)


def _dmrs_rows(cfg: PuschConfig) -> np.ndarray:
    """(L, n_dmrs, 12*n_prb) complex64: each layer's DMRS symbols (pilots x
    frequency OCC x, double-symbol, the time OCC of the symbol's place in
    its pair, on the port's comb; zeros elsewhere)."""
    M = 12 * cfg.n_prb
    dm = np.zeros((cfg.n_layers, len(cfg.dmrs_symbols), M), np.complex64)
    for si, s in enumerate(cfg.dmrs_symbols):
        pil = cfg.dmrs_pilot_np(s)
        for lay in range(cfg.n_layers):
            port = cfg.dmrs_port0 + lay
            if cfg.dmrs_max_len == 2:
                wf, wt, delta = refsig.dmrs_type1_port_weights_double(port)
                tw = complex(wt[si % 2])
            else:
                wf, delta = refsig.dmrs_type1_port_weights(port)
                tw = 1.0
            sc = refsig.dmrs_type1_sc_indices(cfg.n_prb, delta)
            dm[lay, si, sc] = pil * np.tile(wf, 3 * cfg.n_prb) * tw
    return dm


class _Consts(NamedTuple):
    """A configuration's constants on one device."""
    dmrs_rows: torch.Tensor      # (L, n_dmrs, M) complex64 (_dmrs_rows)
    dmrs_combs: tuple            # per layer: (n_pil,) long, its DMRS comb
    pilots: dict                 # DMRS symbol -> (6*n_prb,) complex64
    re_sym: torch.Tensor         # (N,) long: data REs' symbols (data_re_map)
    re_sc: torch.Tensor          # (N,) long: their subcarriers in the allocation
    re_pos: torch.Tensor         # (N,) long: symbol - start_symbol
    ptrs_syms: torch.Tensor      # (n_p,) long: the data symbols carrying PTRS
    ptrs_sc: torch.Tensor        # (K,) long: PTRS subcarriers in the allocation
    ptrs_pilots: torch.Tensor    # (n_p, K) complex64: each PTRS symbol's pilots
    data_syms: torch.Tensor      # (n_data,) long: cfg.data_symbols
    dmrs_syms: torch.Tensor      # (n_dmrs,) long: cfg.dmrs_symbols


@functools.lru_cache(maxsize=64)
def _consts(cfg: PuschConfig, device: torch.device) -> _Consts:
    """The host constants of `cfg` (DMRS rows and pilots, the RE map, PTRS
    positions and pilots), built once per configuration and device."""
    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    combs = []
    for lay in range(cfg.n_layers):
        delta = refsig.dmrs_type1_port_weights((cfg.dmrs_port0 + lay) % 4)[1]
        combs.append(on(refsig.dmrs_type1_sc_indices(cfg.n_prb, delta), torch.long))
    sym_ids, sc_ids = (cfg.data_re_map() if cfg.uses_re_map
                       else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
    p_syms = [s for s, f in zip(cfg.data_symbols, cfg.ptrs_symbol_flags) if f]
    psc = cfg.ptrs_rel_sc() if cfg.ptrs else np.zeros(0, np.int32)
    p_pil = np.zeros((len(p_syms), len(psc)), np.complex64)
    for i, s in enumerate(p_syms):      # DMRS-seeded per symbol, single PTRS port
        p_pil[i] = refsig.dmrs_sequence_np(refsig.dmrs_cinit(cfg.slot, s, cfg.n_id), len(psc))
    return _Consts(
        dmrs_rows=on(_dmrs_rows(cfg)), dmrs_combs=tuple(combs),
        pilots={s: on(cfg.dmrs_pilot_np(s)) for s in cfg.dmrs_symbols},
        re_sym=on(sym_ids, torch.long), re_sc=on(sc_ids, torch.long),
        re_pos=on(sym_ids - cfg.start_symbol, torch.long),
        ptrs_syms=on(p_syms, torch.long), ptrs_sc=on(psc, torch.long),
        ptrs_pilots=on(p_pil), data_syms=on(cfg.data_symbols, torch.long),
        dmrs_syms=on(cfg.dmrs_symbols, torch.long))


# --------------------------------------------------------------------------
# TX
# --------------------------------------------------------------------------

def pusch_tx_grid(cfg: PuschConfig, tb_bits: torch.Tensor, rv: int = 0, uci_cfg=None,
                  ack_bits=None, csi1_bits=None, csi2_bits=None):
    """(B, TBS) payload bits -> ((B, L, symbols, n_sc_bwp) RE grid,
    (B, G) scrambled codeword bits).  With uci_cfg (UciOnPuschConfig) the
    HARQ-ACK and CSI bits are multiplexed into the codeword at distributed
    RE positions before scrambling (TS 38.212 §6.2.7)."""
    _check_ported(cfg)
    _check_branches(cfg, uci_cfg)
    p, crc_name = cfg.seg_params()
    qm, _ = cfg.qm_rate
    B, dev = tb_bits.shape[0], tb_bits.device
    tb_crc = crc_attach(tb_bits.to(torch.int8), crc_name)
    cbs = segmentation.segment_tb(tb_crc, p)            # (B, C, K)
    g = ldpc.build_graph(p.bg, p.Z)
    es = tuple(cfg.cb_e_sizes(None if uci_cfg is None else uci_cfg.g_sizes(cfg)[3]))
    n_cols = rate_matching.tx_cols_needed(g, rv, es, p.F, ncb=cfg.ncb())
    cw = ldpc.encode(g, cbs.reshape(B * p.C, p.K), n_cols=n_cols).reshape(B, p.C, -1)
    codeword = rate_matching.fused_rate_match_tx(g, cw, rv, es, qm, p.F, ncb=cfg.ncb())
    if uci_cfg is not None:
        from .uci_on_pusch import mux_uci_bits
        codeword = mux_uci_bits(cfg, uci_cfg, codeword, ack_bits=ack_bits,
                                csi1_bits=csi1_bits, csi2_bits=csi2_bits)
    scrambled = scramble(codeword, pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id))
    syms = mod.modulate(scrambled, qm)                  # (B, G/qm)
    if cfg.transform_precoding:
        syms = tp.dft_spread(syms, 12 * cfg.n_prb)
    layers = mod.layer_map(syms, cfg.n_layers)          # (B, L, G/(qm L))

    fp, k = cfg.fp, _consts(cfg, dev)
    M, a0 = 12 * cfg.n_prb, cfg.sc0
    grid_re = torch.zeros((B, cfg.n_layers, fp.symbols_per_slot, fp.n_sc),
                          dtype=torch.complex64, device=dev)
    if not cfg.uses_re_map:
        # symbol indices from the device (a host list would be copied over,
        # and wait for the device, on every call)
        grid_re[:, :, k.data_syms, a0: a0 + M] = layers.reshape(
            B, cfg.n_layers, len(cfg.data_symbols), M)
        grid_re[:, :, k.dmrs_syms, a0: a0 + M] = k.dmrs_rows
        return grid_re, scrambled
    # RE map: data in (symbol, subcarrier) order, then the PTRS pilots on
    # layer 0, then each layer's DMRS comb (written last, as in the JAX model)
    grid_re[:, :, k.re_sym, k.re_sc + a0] = layers
    if cfg.ptrs:
        grid_re[:, 0, k.ptrs_syms[:, None], k.ptrs_sc[None, :] + a0] = k.ptrs_pilots
    for si, s in enumerate(cfg.dmrs_symbols):
        for lay, sc in enumerate(k.dmrs_combs):
            grid_re[:, lay, s, sc + a0] = k.dmrs_rows[lay, si, sc]
    return grid_re, scrambled


def pusch_tx(cfg: PuschConfig, tb_bits: torch.Tensor, rv: int = 0, uci_cfg=None,
             ack_bits=None, csi1_bits=None, csi2_bits=None):
    """(B, TBS) payload bits -> ((B, n_tx_ant = n_layers, samples) complex64,
    (B, G) scrambled codeword bits); UCI as in pusch_tx_grid."""
    grid_re, scrambled = pusch_tx_grid(cfg, tb_bits, rv, uci_cfg, ack_bits, csi1_bits,
                                       csi2_bits)
    fp = cfg.fp
    return ofdm_modulate(fp, map_to_grid(fp, grid_re), cfg.slot), scrambled


# --------------------------------------------------------------------------
# RX
# --------------------------------------------------------------------------

def pusch_rx(cfg: PuschConfig, rx_samples: torch.Tensor, rv: int = 0,
             n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """(B, n_rx, samples) -> decoded TB + status.

    Returns a dict with tb_bits (B, TBS), tb_ok (B,), cb_ok (B, C), llrs
    (codeword LLRs or bit planes), harq_buffers (B, C, cols*Z), and with
    uci_cfg the decoded UCI: ack_bits (B, O_ack) and uci (per stream its
    bits and '<stream>_ok'); both None without uci_cfg.
    """
    with profiling.trace("models/pusch.py"):
        fp = cfg.fp
        with profiling.trace("phy/ofdm.py"):
            grid = ofdm_demodulate(fp, rx_samples, cfg.slot)    # (B, R, sym, fft)
            re_grid = extract_from_grid(fp, grid)
        return pusch_rx_grid(cfg, re_grid, rv=rv, n_iters=n_iters,
                             harq_buffers=harq_buffers, uci_cfg=uci_cfg)


def _smooth(cfg: PuschConfig, hp: torch.Tensor) -> torch.Tensor:
    """Pilot-domain smoothing: delay-domain truncation or the moving average."""
    if cfg.chest_mode == "delay":
        return ce.delay_domain_denoise(hp)
    return ce.freq_average(hp, window=cfg.chest_window)


def pusch_channel_estimate(cfg: PuschConfig, re_grid: torch.Tensor,
                           n_ports: int | None = None):
    """LS channel estimation at the DMRS REs -> ((B, R, P, M) h, (B,) nvar).

    LS per DMRS symbol averaged over the symbols (block fading), CDM
    separation of the ports sharing a comb (the frequency OCC; with
    double-symbol DMRS the time OCC across each symbol pair too), smoothing
    (moving average or delay-domain truncation) and comb-2 interpolation.
    n_ports overrides the estimated port count (one joint estimate over two
    codewords' layers).
    """
    M, a0 = 12 * cfg.n_prb, cfg.sc0
    P = cfg.n_layers if n_ports is None else n_ports
    ports = list(range(cfg.dmrs_port0, cfg.dmrs_port0 + P))
    double = cfg.dmrs_max_len == 2
    if double:
        if len(cfg.dmrs_symbols) % 2:
            raise ValueError("double-symbol DMRS needs symbol pairs")
        groups = [tuple(cfg.dmrs_symbols[i: i + 2])
                  for i in range(0, len(cfg.dmrs_symbols), 2)]
    else:
        groups = [(s,) for s in cfg.dmrs_symbols]
    pilots = _consts(cfg, re_grid.device).pilots

    def delta_of(p):
        return refsig.dmrs_type1_port_weights(p % 4)[1]

    h_by_port: dict[int, torch.Tensor] = {}
    nvar_terms = []                                      # each (B, R, k)
    for delta in sorted({delta_of(p) for p in ports}):
        g_ports = [p for p in ports if delta_of(p) == delta]
        sc = torch.as_tensor(refsig.dmrs_type1_sc_indices(cfg.n_prb, delta) + a0,
                             dtype=torch.long, device=re_grid.device)
        # LS per symbol of each group, shared by the group's ports
        ls_groups = [[ce.ls_estimate(re_grid[:, :, s, :][..., sc], pilots[s]) for s in grp]
                     for grp in groups]                  # each (B, R, n_pil)
        if not double and (P > 1 or len(g_ports) > 1):
            # vectorized CDM separation: the ports differ by the OCC sign on
            # odd pilots
            wf1 = torch.as_tensor([refsig.dmrs_type1_port_weights(p % 4)[0][1]
                                   for p in g_ports], device=re_grid.device)
            ls = sum(ls_t[0] for ls_t in ls_groups) / len(ls_groups)
            pairs = 0.5 * (ls[..., None, 0::2] + wf1[:, None] * ls[..., None, 1::2])
            dd = pairs[..., 1:] - pairs[..., :-1]
            # pairs average the DMRS symbols: scale back to the per-symbol variance
            nvar_terms.append(torch.mean(dd.abs() ** 2, dim=-1) * len(ls_groups))
            hs = ce.comb2_interpolate(_smooth(cfg, pairs.repeat_interleave(2, dim=-1)),
                                      M, delta)          # (B, R, Pg, M)
            for i, p in enumerate(g_ports):
                h_by_port[p] = hs[:, :, i]
            continue
        # per port: the time OCC over each pair (double), then the
        # frequency OCC; the noise term from the separated pairs
        for p in g_ports:
            if double:
                wf, wt, _ = refsig.dmrs_type1_port_weights_double(p)
            else:
                wf, _ = refsig.dmrs_type1_port_weights(p)
                wt = np.array([1.0], np.float32)
            hp_groups = []
            for ls_t in ls_groups:
                ls = sum(l * float(wt[li]) for li, l in enumerate(ls_t)) / len(ls_t)
                if P > 1 or double:
                    pair = 0.5 * (ls[..., 0::2] + float(wf[1]) * ls[..., 1::2])
                    d = pair[..., 1:] - pair[..., :-1]
                    nvar_terms.append(torch.mean(d.abs() ** 2, dim=-1)[..., None])
                    hp_groups.append(pair)
                else:
                    nvar_terms.append(ce.noise_variance(None, ls, None)[..., None])
                    hp_groups.append(ls)
            hp = sum(hp_groups) / len(hp_groups)
            if P > 1 or double:
                hp = hp.repeat_interleave(2, dim=-1)
            h_by_port[p] = ce.comb2_interpolate(_smooth(cfg, hp), M, delta)
    h_est = torch.stack([h_by_port[p] for p in ports], dim=2)
    nvar = torch.cat(nvar_terms, dim=-1).mean(dim=(-2, -1))
    return h_est, nvar


def pusch_equalize(cfg: PuschConfig, re_grid: torch.Tensor, h_est, nvar):
    """Equalize the data REs -> (x, mag): (B, P, S, M) symbol blocks for a
    rectangular allocation (DFT-despread with transform precoding), (B, P, N)
    per data RE of the RE map (block fading: h depends on the subcarrier
    only)."""
    M, a0 = 12 * cfg.n_prb, cfg.sc0
    P = h_est.shape[2]
    if cfg.uses_re_map:
        k = _consts(cfg, re_grid.device)
        y = re_grid[:, :, k.re_sym, k.re_sc + a0]          # (B, R, N)
        h_re = h_est[..., k.re_sc]                          # (B, R, P, N)
        if P == 1:
            x, mag = eq.mrc_compensate(h_re[:, :, 0, :], y)
            return x[:, None], mag[:, None]
        if P == 2:
            return eq.mmse_equalize_2layer(h_re, y, nvar[:, None])
        return eq.zf_equalize(h_re, y, nvar[:, None, None, None])
    y = re_grid[:, :, list(cfg.data_symbols), a0: a0 + M]   # (B, R, S, M)
    if P > 1:
        return _mmse_over_syms(h_est, y, nvar)
    x, mag = _mrc_over_syms(h_est[:, :, 0, :], y)
    if cfg.transform_precoding:
        B, S = x.shape[:2]
        xd, md = tp.idft_despread(x.reshape(B, S * M), mag.reshape(B, S * M), M)
        x, mag = xd.reshape(B, S, M), md.reshape(B, S, M)
    return x[:, None], mag[:, None]


def _ptrs_phases(cfg: PuschConfig, re_grid: torch.Tensor, h_est: torch.Tensor) -> torch.Tensor:
    """(B, n_symbols) common-phase phasors exp(-j phi), one per symbol of the
    allocation: from each PTRS symbol's correlation with layer 0's channel
    and pilots, summed over the antennas; held forward to the next PTRS
    symbol, leading symbols take the first."""
    k = _consts(cfg, re_grid.device)
    a0 = cfg.sc0
    hp = h_est[:, :, 0, :][..., k.ptrs_sc]                  # (B, R, K)
    yp = re_grid[:, :, k.ptrs_syms[:, None], k.ptrs_sc[None, :] + a0]   # (B, R, n_p, K)
    z = torch.sum(yp * torch.conj(hp[:, :, None] * k.ptrs_pilots), dim=(1, 3))  # (B, n_p)
    cur = torch.conj(z / torch.clamp(z.abs(), min=1e-12))
    # the phasor of each allocation symbol: the last PTRS symbol at or before
    # it, else the first
    syms = np.arange(cfg.start_symbol, cfg.start_symbol + cfg.n_symbols)
    p_syms = np.array([s for s, f in zip(cfg.data_symbols, cfg.ptrs_symbol_flags) if f])
    src = np.maximum(np.searchsorted(p_syms, syms, side="right") - 1, 0)
    return cur[:, torch.as_tensor(src, device=cur.device)]


def pusch_llrs(cfg: PuschConfig, re_grid: torch.Tensor, x, mag,
               h_est=None) -> torch.Tensor:
    """Compensated symbols of this codeword's layers, (B, L, S, M) blocks or
    (B, L, N) RE-map values -> descrambled codeword LLRs (B, G): PTRS
    common-phase tracking (a PTRS configuration always takes the RE map),
    LLRs, descrambling."""
    qm, _ = cfg.qm_rate
    B = x.shape[0]
    if cfg.ptrs:
        phase = _ptrs_phases(cfg, re_grid, h_est)           # (B, n_symbols)
        x = x * phase[:, None, _consts(cfg, x.device).re_pos]
    llrs = llr_mod.llrs(x.reshape(B, cfg.n_layers, -1),
                        mag.reshape(B, cfg.n_layers, -1), qm)   # (B, L, N*qm)
    # symbol i went to layer i % L: interleave the per-symbol qm-bit groups
    llr_cw = llrs.reshape(B, cfg.n_layers, -1, qm).transpose(1, 2).reshape(B, -1)
    return _descramble(cfg, llr_cw)


def _descramble(cfg: PuschConfig, llr_cw: torch.Tensor) -> torch.Tensor:
    llr_cw = scramble_llrs(llr_cw, pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id))
    if cfg.llr_quant_bits:
        llr_cw = llr_mod.quantize(llr_cw, bits=cfg.llr_quant_bits)
    return llr_cw


def _use_kernel_frontend(cfg: PuschConfig, re_grid: torch.Tensor) -> bool:
    """The fused frontend runs when supported and asked for ('kernel'), or
    by 'auto' for CUDA tensors."""
    if cfg.frontend_backend == "reference":
        return False
    if fe.supported(cfg):
        return cfg.frontend_backend == "kernel" or re_grid.is_cuda
    if cfg.frontend_backend == "kernel":
        raise ValueError("frontend_backend='kernel' needs a configuration "
                         "ops/pusch_frontend.supported accepts")
    return False


def pusch_frontend(cfg: PuschConfig, re_grid: torch.Tensor) -> torch.Tensor:
    """RE grid (B, n_rx, symbols, n_sc_bwp) -> descrambled codeword LLRs
    (B, G): channel estimation, MRC/MMSE/ZF or 2-layer ML detection, PTRS
    phase tracking, LLRs, descrambling."""
    _check_ported(cfg)
    _check_branches(cfg)
    if _use_kernel_frontend(cfg, re_grid):
        return fe.frontend(cfg, re_grid)
    h_est, nvar = pusch_channel_estimate(cfg, re_grid)
    if cfg.receiver == "ml":
        M, a0 = 12 * cfg.n_prb, cfg.sc0
        y = re_grid[:, :, list(cfg.data_symbols), a0: a0 + M]
        llr = ml_llrs_2layer(h_est, y, cfg.qm_rate[0], nvar)    # (B, 2, S, M, qm)
        return _descramble(cfg, llr.permute(0, 2, 3, 1, 4).reshape(re_grid.shape[0], -1))
    x, mag = pusch_equalize(cfg, re_grid, h_est, nvar)
    return pusch_llrs(cfg, re_grid, x, mag, h_est)


def pusch_rx_grid(cfg: PuschConfig, re_grid: torch.Tensor, rv: int = 0,
                  n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """RX from a (B, n_rx, symbols, n_sc_bwp) RE grid.  On the kernel path
    the frontend emits bit planes that rate recovery slices; the
    codeword-order LLR vector never exists.  With uci_cfg the UCI streams
    are cut from pusch_frontend's codeword-order LLRs."""
    _check_ported(cfg)
    _check_branches(cfg, uci_cfg)
    if uci_cfg is None and not cfg.llr_quant_bits and _use_kernel_frontend(cfg, re_grid):
        with profiling.trace("ops/pusch_frontend.py"):
            planes = fe.frontend_planes(cfg, re_grid)
        return pusch_decode_codeword(cfg, None, rv=rv, n_iters=n_iters,
                                     harq_buffers=harq_buffers, planes=planes)
    return pusch_decode_codeword(cfg, pusch_frontend(cfg, re_grid), rv=rv,
                                 n_iters=n_iters, harq_buffers=harq_buffers, uci_cfg=uci_cfg)


def pusch_decode_codeword(cfg: PuschConfig, llr_cw, rv: int = 0,
                          n_iters: int = 20, harq_buffers=None, uci_cfg=None,
                          planes=None):
    """Descrambled codeword LLRs (B, G), or bit planes (B, qm, G//qm) via
    planes=, -> decoded TB dict (UCI demux + rate recovery + batched LDPC
    decode + CRC)."""
    _check_ported(cfg)
    p, crc_name = cfg.seg_params()
    qm, _ = cfg.qm_rate
    B = (planes if llr_cw is None else llr_cw).shape[0]
    ack_bits = uci = None
    g_data = None
    if uci_cfg is not None:
        from .uci_on_pusch import decode_uci, demux_uci_llrs
        streams = demux_uci_llrs(cfg, uci_cfg, llr_cw)
        uci = decode_uci(cfg, uci_cfg, streams)
        ack_bits = uci.get("ack")
        llr_cw = streams["data"]
        g_data = uci_cfg.g_sizes(cfg)[3]
    g = ldpc.build_graph(p.bg, p.Z)
    es = tuple(cfg.cb_e_sizes(g_data))
    if planes is not None:
        # The mother-code buffer is staged in bf16 for the decoder kernel
        # when Z % 128 == 0, the rule of the JAX receiver, so the two decode
        # the same values; the kernel reads bf16 directly.
        src = (planes.to(torch.bfloat16)
               if cfg.decoder_backend == "kernel" and p.Z % 128 == 0 else planes)
        with profiling.trace("coding/rate_recovery"):
            stacked = rate_matching.fused_rate_match_rx_planes(
                g, src, rv, es, qm, p.F, harq_buffer=harq_buffers, ncb=cfg.ncb())
        llr_cw = planes
    else:
        with profiling.trace("coding/rate_recovery"):
            stacked = rate_matching.fused_rate_match_rx(
                g, llr_cw, rv, es, qm, p.F, harq_buffer=harq_buffers, ncb=cfg.ncb())
    decode, llr_cbs = ldpc_decoder(cfg.decoder_backend), stacked.reshape(B * p.C, -1)
    with profiling.trace("coding/decode"):
        if cfg.decoder_backend == "kernel" and profiling.active():
            # K1's own iterations per code block, kept on the device unread
            bits_all, ok_all, iters = decode(g, llr_cbs, n_iters=n_iters,
                                             check_every=cfg.decoder_check_every,
                                             return_iters=True)
            profiling.count("coding/decode:iters", iters)
        else:
            bits_all, ok_all = decode(g, llr_cbs, n_iters=n_iters,
                                      check_every=cfg.decoder_check_every)
    cbs = bits_all.reshape(B, p.C, -1)
    with profiling.trace("coding/desegment"):
        tb_with_crc = segmentation.desegment_tb(cbs, p)
    with profiling.trace("coding/crc"):
        tb_ok = crc_ok(tb_with_crc, crc_name)
    Lc = CRC_POLYS[crc_name][0]
    return {
        "tb_bits": tb_with_crc[..., :-Lc],
        "tb_ok": tb_ok,
        "cb_ok": ok_all.reshape(B, p.C),
        "llrs": llr_cw,
        "harq_buffers": stacked,
        "ack_bits": ack_bits,
        "uci": uci,
    }


def _mrc_over_syms(h, y):
    """h: (B, R, M), y: (B, R, S, M) -> MRC over the antennas, per symbol."""
    x = torch.sum(torch.conj(h)[:, :, None, :] * y, dim=1)
    mag = torch.sum(h.abs() ** 2, dim=1)[:, None, :].expand(x.shape)
    return x, mag


def _mmse_over_syms(h, y, nvar):
    """h: (B, R, L, M), y: (B, R, S, M), nvar (B,) -> (B, L, S, M) pair;
    block fading: one h for every data symbol of the slot."""
    B, R, L, M = h.shape
    ys = y.transpose(1, 2)                              # (B, S, R, M)
    if L == 2:
        x, eff = eq.mmse_equalize_2layer(h[:, None], ys, nvar.reshape(B, 1, 1))
    else:
        x, eff = eq.zf_equalize(h[:, None], ys, nvar.reshape(B, 1, 1, 1, 1))
    return x.transpose(1, 2), eff.expand(x.shape).transpose(1, 2)
