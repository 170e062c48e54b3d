"""PUSCH end-to-end chain: UE TX -> gNB RX.

Port of openairinterface5g_tpu/models/pusch.py for the rectangular CP-OFDM
allocation with single-symbol DMRS:

  TX: CRC -> segmentation -> LDPC encode -> rate match -> scramble ->
      modulate -> layer map -> DMRS -> RE map -> IFFT
  RX: FFT -> [fused frontend kernel | channel estimation -> MRC/MMSE ->
      LLR -> descramble] -> rate recovery -> LDPC decode -> CRC

Tensors keep the JAX package's layouts: (B, n_rx, symbols, n_sc_bwp) RE
grids, (B, qm, G/qm) bit planes, a (B, C, cols*Z) mother-code buffer.  The
slot batch is the leading dimension.  Branches of the JAX model that are
not ported yet raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses

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
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from ..phy.scrambling import pusch_cinit, scramble, scramble_llrs
from ..transport import compute_tbs, mcs_to_qm_rate

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
    chest_mode: str = "window"       # 'window' ('delay' not ported yet)
    ptrs: bool = False
    ptrs_k: int = 2
    ptrs_l: int = 1
    ptrs_re_offset: int = 0
    dmrs_max_len: int = 1
    dmrs_port0: int = 0              # first DMRS port
    cdm_groups_no_data: int = 2      # 2 = DMRS symbols carry no data
    scrambling_q: int = 0            # codeword index q
    tbs_lbrm: int | None = None      # LBRM reference TBS (38.212 5.4.2.1)
    receiver: str = "linear"         # 'linear' ('ml' not ported yet)
    rm_res: tuple = ()               # rate-match pattern REs (not ported yet)

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
    def uses_re_map(self) -> bool:
        """True when data REs are not a rectangle (PTRS holes, data on the
        free comb of DMRS symbols, or a rate-match pattern)."""
        return self.ptrs or self.cdm_groups_no_data == 1 or bool(self.rm_res)

    @property
    def n_data_re(self) -> int:
        if self.ptrs or self.rm_res:
            _check_ported(self)
        n = len(self.data_symbols) * 12 * self.n_prb
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
        """(6*n_prb,) CP-OFDM DMRS pilots of a DMRS symbol (host constant)."""
        if self.transform_precoding:
            _check_ported(self)
        cinit = refsig.dmrs_cinit(self.slot, symbol, self.n_id)
        return refsig.dmrs_sequence_np(cinit, 6 * self.n_prb)

    def cb_e_sizes(self, g_total: int | None = None) -> list[int]:
        """Per-code-block rate-matched lengths E_j (TS 38.212 §5.4.2.1)."""
        p, _ = self.seg_params()
        qm = self.qm_rate[0]
        C, Nl = p.C, self.n_layers
        gp = (self.G if g_total is None else g_total) // (Nl * qm)
        gamma = gp % C
        return [Nl * qm * (gp // C) if j <= C - 1 - gamma else Nl * qm * (-(-gp // C))
                for j in range(C)]


def _check_ported(cfg: PuschConfig, uci_cfg=None) -> None:
    """Raise for the JAX model's branches that this port does not run yet."""
    missing = [
        (uci_cfg is not None, "UCI on PUSCH", 7),
        (cfg.transform_precoding, "transform precoding (DFT-s-OFDM)", 7),
        (cfg.receiver != "linear", f"receiver={cfg.receiver!r}", 7),
        (cfg.ptrs, "PTRS", 3),
        (bool(cfg.rm_res), "rate-match patterns (rm_res)", 3),
        (cfg.cdm_groups_no_data != 2, "data on the DMRS symbols (cdm_groups_no_data=1)", 3),
        (cfg.dmrs_max_len != 1, "double-symbol DMRS", 3),
        (cfg.chest_mode != "window", f"chest_mode={cfg.chest_mode!r}", 3),
    ]
    for hit, what, item in missing:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}")
    if cfg.decoder_first_iters:
        raise NotImplementedError(
            "decoder_first_iters (two-phase decode) is not carried into the port: "
            "ROADMAP.md 'Not carried into the port'")


def _dmrs_rows(cfg: PuschConfig) -> np.ndarray:
    """(L, n_dmrs, 12*n_prb) complex64: each layer's DMRS symbols
    (pilots x frequency OCC on the port's comb, zeros elsewhere)."""
    M = 12 * cfg.n_prb
    dm = np.zeros((cfg.n_layers, len(cfg.dmrs_symbols), M), np.complex64)
    for si, s in enumerate(cfg.dmrs_symbols):
        pil = cfg.dmrs_pilot_np(s)
        for lay in range(cfg.n_layers):
            wf, delta = refsig.dmrs_type1_port_weights(cfg.dmrs_port0 + lay)
            sc = refsig.dmrs_type1_sc_indices(cfg.n_prb, delta)
            dm[lay, si, sc] = pil * np.tile(wf, 3 * cfg.n_prb)
    return dm


# --------------------------------------------------------------------------
# TX
# --------------------------------------------------------------------------

def pusch_tx_grid(cfg: PuschConfig, tb_bits: torch.Tensor, rv: int = 0):
    """(B, TBS) payload bits -> ((B, L, symbols, n_sc_bwp) RE grid,
    (B, G) scrambled codeword bits)."""
    _check_ported(cfg)
    p, crc_name = cfg.seg_params()
    qm, _ = cfg.qm_rate
    B, dev = tb_bits.shape[0], tb_bits.device
    tb_crc = crc_attach(tb_bits.to(torch.int8), crc_name)
    cbs = segmentation.segment_tb(tb_crc, p)            # (B, C, K)
    g = ldpc.build_graph(p.bg, p.Z)
    es = tuple(cfg.cb_e_sizes())
    n_cols = rate_matching.tx_cols_needed(g, rv, es, p.F, ncb=cfg.ncb())
    cw = ldpc.encode(g, cbs.reshape(B * p.C, p.K), n_cols=n_cols).reshape(B, p.C, -1)
    codeword = rate_matching.fused_rate_match_tx(g, cw, rv, es, qm, p.F, ncb=cfg.ncb())
    scrambled = scramble(codeword, pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id))
    layers = mod.layer_map(mod.modulate(scrambled, qm), cfg.n_layers)   # (B, L, S*M)

    fp = cfg.fp
    M, a0 = 12 * cfg.n_prb, cfg.sc0
    grid_re = torch.zeros((B, cfg.n_layers, fp.symbols_per_slot, fp.n_sc),
                          dtype=torch.complex64, device=dev)
    grid_re[:, :, list(cfg.data_symbols), a0: a0 + M] = layers.reshape(
        B, cfg.n_layers, len(cfg.data_symbols), M)
    grid_re[:, :, list(cfg.dmrs_symbols), a0: a0 + M] = torch.as_tensor(
        _dmrs_rows(cfg), device=dev)
    return grid_re, scrambled


def pusch_tx(cfg: PuschConfig, tb_bits: torch.Tensor, rv: int = 0):
    """(B, TBS) payload bits -> ((B, n_tx_ant = n_layers, samples) complex64,
    (B, G) scrambled codeword bits)."""
    grid_re, scrambled = pusch_tx_grid(cfg, tb_bits, rv)
    fp = cfg.fp
    return ofdm_modulate(fp, map_to_grid(fp, grid_re), cfg.slot), scrambled


# --------------------------------------------------------------------------
# RX
# --------------------------------------------------------------------------

def pusch_rx(cfg: PuschConfig, rx_samples: torch.Tensor, rv: int = 0,
             n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """(B, n_rx, samples) -> decoded TB + status.

    Returns a dict with tb_bits (B, TBS), tb_ok (B,), cb_ok (B, C), llrs
    (codeword LLRs or bit planes) and harq_buffers (B, C, cols*Z).
    """
    fp = cfg.fp
    grid = ofdm_demodulate(fp, rx_samples, cfg.slot)    # (B, R, sym, fft)
    return pusch_rx_grid(cfg, extract_from_grid(fp, grid), rv=rv, n_iters=n_iters,
                         harq_buffers=harq_buffers, uci_cfg=uci_cfg)


def pusch_channel_estimate(cfg: PuschConfig, re_grid: torch.Tensor,
                           n_ports: int | None = None):
    """LS channel estimation at the DMRS REs -> ((B, R, P, M) h, (B,) nvar).

    LS per DMRS symbol averaged over the symbols (block fading), CDM
    separation of the ports sharing a comb, moving-average smoothing and
    comb-2 interpolation.  n_ports overrides the estimated port count.
    """
    _check_ported(cfg)
    M, a0 = 12 * cfg.n_prb, cfg.sc0
    P = cfg.n_layers if n_ports is None else n_ports
    ports = list(range(cfg.dmrs_port0, cfg.dmrs_port0 + P))
    n_d = len(cfg.dmrs_symbols)
    dev = re_grid.device

    def delta_of(p):
        return refsig.dmrs_type1_port_weights(p % 4)[1]

    h_by_port: dict[int, torch.Tensor] = {}
    nvar_terms = []                                      # each (B, R, k)
    for delta in sorted({delta_of(p) for p in ports}):
        g_ports = [p for p in ports if delta_of(p) == delta]
        sc = torch.as_tensor(refsig.dmrs_type1_sc_indices(cfg.n_prb, delta) + a0,
                             dtype=torch.long, device=dev)
        ls_syms = [ce.ls_estimate(re_grid[:, :, s, :][..., sc],
                                  torch.as_tensor(cfg.dmrs_pilot_np(s), device=dev))
                   for s in cfg.dmrs_symbols]            # each (B, R, n_pil)
        ls = sum(ls_syms) / n_d
        if P > 1 or len(g_ports) > 1:
            # CDM separation: the ports differ by the OCC sign on odd pilots
            wf1 = torch.as_tensor([refsig.dmrs_type1_port_weights(p % 4)[0][1]
                                   for p in g_ports], device=dev)
            pairs = 0.5 * (ls[..., None, 0::2] + wf1[:, None] * ls[..., None, 1::2])
            dd = pairs[..., 1:] - pairs[..., :-1]
            # pairs average n_d symbols: scale back to the per-symbol variance
            nvar_terms.append(torch.mean(dd.abs() ** 2, dim=-1) * n_d)
            hp = pairs.repeat_interleave(2, dim=-1)      # (B, R, Pg, n_pil)
        else:
            nvar_terms += [ce.noise_variance(None, l, None)[..., None] for l in ls_syms]
            hp = ls
        hs = ce.comb2_interpolate(ce.freq_average(hp, window=cfg.chest_window), M, delta)
        if hs.dim() == 3:
            hs = hs[:, :, None]
        for i, p in enumerate(g_ports):
            h_by_port[p] = hs[:, :, i]
    h_est = torch.stack([h_by_port[p] for p in ports], dim=2)
    nvar = torch.cat(nvar_terms, dim=-1).mean(dim=(-2, -1))
    return h_est, nvar


def pusch_equalize(cfg: PuschConfig, re_grid: torch.Tensor, h_est, nvar):
    """Equalize the data REs -> (x (B, P, S, M), mag (B, P, S, M))."""
    M, a0 = 12 * cfg.n_prb, cfg.sc0
    y = re_grid[:, :, list(cfg.data_symbols), a0: a0 + M]   # (B, R, S, M)
    if h_est.shape[2] == 1:
        x, mag = _mrc_over_syms(h_est[:, :, 0, :], y)
        return x[:, None], mag[:, None]
    return _mmse_over_syms(h_est, y, nvar)


def pusch_llrs(cfg: PuschConfig, x, mag) -> torch.Tensor:
    """Compensated symbols (B, L, S, M) -> descrambled codeword LLRs (B, G)."""
    qm, _ = cfg.qm_rate
    B = x.shape[0]
    llrs = llr_mod.llrs(x.reshape(B, cfg.n_layers, -1),
                        mag.reshape(B, cfg.n_layers, -1), qm)   # (B, L, S*M*qm)
    # symbol i went to layer i % L: interleave the per-symbol qm-bit groups
    llr_cw = llrs.reshape(B, cfg.n_layers, -1, qm).transpose(1, 2).reshape(B, -1)
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
    (B, G): channel estimation, MRC/MMSE, LLRs, descrambling."""
    _check_ported(cfg)
    if _use_kernel_frontend(cfg, re_grid):
        return fe.frontend(cfg, re_grid)
    h_est, nvar = pusch_channel_estimate(cfg, re_grid)
    x, mag = pusch_equalize(cfg, re_grid, h_est, nvar)
    return pusch_llrs(cfg, x, mag)


def pusch_rx_grid(cfg: PuschConfig, re_grid: torch.Tensor, rv: int = 0,
                  n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """RX from a (B, n_rx, symbols, n_sc_bwp) RE grid.  On the kernel path
    the frontend emits bit planes that rate recovery slices; the
    codeword-order LLR vector never exists."""
    _check_ported(cfg, uci_cfg)
    if not cfg.llr_quant_bits and _use_kernel_frontend(cfg, re_grid):
        planes = fe.frontend_planes(cfg, re_grid)
        return pusch_decode_codeword(cfg, None, rv=rv, n_iters=n_iters,
                                     harq_buffers=harq_buffers, planes=planes)
    return pusch_decode_codeword(cfg, pusch_frontend(cfg, re_grid), rv=rv,
                                 n_iters=n_iters, harq_buffers=harq_buffers)


def pusch_decode_codeword(cfg: PuschConfig, llr_cw, rv: int = 0,
                          n_iters: int = 20, harq_buffers=None, uci_cfg=None,
                          planes=None):
    """Descrambled codeword LLRs (B, G), or bit planes (B, qm, G//qm) via
    planes=, -> decoded TB dict (rate recovery + batched LDPC decode + CRC)."""
    _check_ported(cfg, uci_cfg)
    p, crc_name = cfg.seg_params()
    qm, _ = cfg.qm_rate
    B = (planes if llr_cw is None else llr_cw).shape[0]
    g = ldpc.build_graph(p.bg, p.Z)
    es = tuple(cfg.cb_e_sizes())
    if planes is not None:
        # The mother-code buffer is staged in bf16 for the decoder kernel
        # when Z % 128 == 0, the rule of the JAX receiver, so the two decode
        # the same values; the kernel reads bf16 directly.
        src = (planes.to(torch.bfloat16)
               if cfg.decoder_backend == "kernel" and p.Z % 128 == 0 else planes)
        stacked = rate_matching.fused_rate_match_rx_planes(
            g, src, rv, es, qm, p.F, harq_buffer=harq_buffers, ncb=cfg.ncb())
        llr_cw = planes
    else:
        stacked = rate_matching.fused_rate_match_rx(
            g, llr_cw, rv, es, qm, p.F, harq_buffer=harq_buffers, ncb=cfg.ncb())
    bits_all, ok_all = ldpc_decoder(cfg.decoder_backend)(
        g, stacked.reshape(B * p.C, -1), n_iters=n_iters,
        check_every=cfg.decoder_check_every)
    tb_with_crc = segmentation.desegment_tb(bits_all.reshape(B, p.C, -1), p)
    Lc = CRC_POLYS[crc_name][0]
    return {
        "tb_bits": tb_with_crc[..., :-Lc],
        "tb_ok": crc_ok(tb_with_crc, crc_name),
        "cb_ok": ok_all.reshape(B, p.C),
        "llrs": llr_cw,
        "harq_buffers": stacked,
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
