"""The benchmark's plain reference of the NR uplink shared channel at 1 to 4
layers, where the layers take both CDM groups of type-1 DMRS.

``nr.py`` stops at 2 layers, both on CDM group 0.  This module is its
4-port half, written on top of it in plain float32 PyTorch, and imports
nothing of the program under test.  It covers what ``nr.py`` covers (CP-OFDM,
a rectangular allocation over the whole carrier, single-symbol DMRS at one
or more positions with no data beside it, MCS table 1, redundancy version
0), at 1 to 4 layers on DMRS ports 0 to L - 1.  The sizes (``nr.Pusch``), the
coding chain, the OFDM, the Gold sequence and the decoder are ``nr``'s own;
``nr.Pusch`` is built directly (``pusch``), since ``nr.Pusch.from_config``
refuses more than 2 layers.

Transmitter (``transmit``), TS 38.211:

- §6.4.1.1.3, Table 6.4.1.1.3-1, type 1, single symbol: port p sits on
  comb Delta(p), 0 for ports 0-1 and 1 for ports 2-3, at subcarrier
  4n + 2k' + Delta with the pilot r(2n + k') times w_f(k'): (+1, +1) on
  ports 0 and 2, (+1, -1) on ports 1 and 3 (``port_comb``);
- §7.3.1.3 (as §6.3.1.3 refers to it), layer mapping x^(l)(i) = d(L i + l),
  which ``nr.slot_grid``'s reshape does; the DMRS symbols carry no data
  (two CDM groups without data).

Receiver (``receive``), the one the program states, so that the two
compare number for number:

- per CDM group, the LS estimate on the group's comb averaged over the
  DMRS symbols; at 2 or more layers the OCC pairs (the mean of a pilot
  pair, the odd pilot times the port's w_f(1)), the noise variance from
  the differences of adjacent pairs, averaged over antennas, ports and
  groups and scaled back to one DMRS symbol; the window's moving average
  with the edge values repeated (``nr._moving_average``); the comb-2
  interpolation: on comb 0 each odd subcarrier the mean of its neighbours
  and the last one held (``nr._interpolate``), on comb 1 each even
  subcarrier the mean of the pilots left and right of it and the first
  one held (``_interpolate_comb1``);
- one layer: MRC.  2 or more: per subcarrier A = H^H H + nvar I, then
  x = A^-1 H^H y for every data RE of the subcarrier and the gain
  mag = diag(A^-1 H^H H), by ``torch.linalg.solve``;
- max-log LLRs scaled by mag as ``nr.frontend_llrs`` forms them, in
  (RE, layer, bit) order, descrambled with ``nr.gold(nr.data_cinit(p), G)``;
  then ``nr``'s rate recovery (``recover``: its buffer, handed to the
  decoder in float32, as the eager frontend hands it to K1), decoder and
  desegmentation.

Departures from TS 38.211 and TS 38.214, each as ``nr.py`` and the program
make them: no PUSCH-to-DMRS EPRE ratio beta_DMRS (TS 38.214 Table 6.2.2-1
gives -3 dB with two CDM groups without data; the DMRS goes at the data's
unit power); no precoding (TS 38.211 §6.3.1.5 with W the identity); the
ports are 0 to L - 1, one per layer; the receiver, which the
specifications leave open, is the program's.

Float32 throughout; ``q`` rounds the frontend's intermediate values
(``nr.exact`` for the reference, ``nr.bf16`` for the control).  A float32
matrix product on the card may run in TF32, so the transmitter and the
receiver run with TF32 off (``float32_matmul``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark import nr


def pusch(c: dict) -> nr.Pusch:
    """The configuration file as the reference reads it, at 1 to 4 layers."""
    if c.get("mcs_table", 1) != 1 or not c["dmrs_symbols"] or not 1 <= c["n_layers"] <= 4:
        raise ValueError("the reference covers MCS table 1, single-symbol DMRS, 1-4 layers")
    return nr.Pusch(mu=c["mu"], n_prb=c["n_prb"], mcs=c["mcs"], n_layers=c["n_layers"],
                    n_symbols=c["n_symbols"], dmrs_symbols=tuple(sorted(c["dmrs_symbols"])),
                    rnti=c["rnti"], n_id=c["n_id"], slot=c["slot"], n_rx=c["n_rx"],
                    chest_window=c["chest_window"], n_iters=c["n_iters"],
                    check_every=c["decoder_check_every"])


def float32_matmul(fn):
    """fn run with TF32 off in float32 matrix products and convolutions,
    the settings put back after it."""
    @functools.wraps(fn)
    def run(*args, **kw):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return run


def port_comb(port: int) -> tuple:
    """(Delta, w_f(1)) of a single-symbol type-1 DMRS port 0-3 (TS 38.211
    Table 6.4.1.1.3-1): its CDM group's comb and the sign of the odd pilot
    of each pair."""
    return (0 if port < 2 else 1), (1.0 if port % 2 == 0 else -1.0)


def dmrs_row(p: nr.Pusch, symbol: int, port: int) -> np.ndarray:
    """(n_sc,) complex64: the port's DMRS in a DMRS symbol, zero off its comb."""
    delta, w1 = port_comb(port)
    row = np.zeros(p.n_sc, np.complex64)
    row[delta::2] = nr.dmrs_pilots(p, symbol) * np.tile([1.0, w1], 3 * p.n_prb)
    return row


def slot_grid(p: nr.Pusch, bits: torch.Tensor) -> torch.Tensor:
    """(n, G) scrambled codeword bits -> (n, layers, 14, n_sc) complex64 RE
    grid: ``nr.slot_grid``'s QAM, layer mapping and data symbols, each
    layer's DMRS symbols then written whole with its port's comb and OCC."""
    grid = nr.slot_grid(p, bits)
    for s in p.dmrs_symbols:
        for lay in range(p.n_layers):
            grid[:, lay, s] = torch.as_tensor(dmrs_row(p, s, lay), device=grid.device)
    return grid


@float32_matmul
def transmit(p: nr.Pusch, tb: torch.Tensor) -> torch.Tensor:
    """(n, A) transport blocks -> (n, layers, samples) complex64 slots."""
    return nr.ofdm_modulate(p, slot_grid(p, nr.codeword_bits(p, tb)))


def _interpolate_comb1(hp: torch.Tensor, M: int) -> torch.Tensor:
    """Comb 1 estimates (..., M/2) -> (..., M): each even subcarrier the mean
    of the pilots either side of it, the first one holds."""
    left = torch.cat([hp[..., :1], 0.5 * (hp[..., :-1] + hp[..., 1:])], dim=-1)
    return torch.stack([left, hp], dim=-1).reshape(*hp.shape[:-1], M)


def estimate(p: nr.Pusch, y: torch.Tensor, q: nr.Quantize = nr.exact) -> tuple:
    """(n, R, 14, M) RE grid -> (h (n, R, L, M), nvar (n,) or None at 1 layer)."""
    M, L, dev = p.n_sc, p.n_layers, y.device
    h: list = [None] * L
    terms = []
    for delta in sorted({port_comb(lay)[0] for lay in range(L)}):
        ports = [lay for lay in range(L) if port_comb(lay)[0] == delta]
        ls_sym = [q(y[:, :, s, delta::2] * torch.as_tensor(nr.dmrs_pilots(p, s), device=dev).conj())
                  for s in p.dmrs_symbols]                         # each (n, R, M/2)
        ls = q(sum(ls_sym) / len(ls_sym))                          # block fading
        interp = nr._interpolate if delta == 0 else _interpolate_comb1
        if L == 1:
            h[0] = q(interp(q(nr._moving_average(ls, p.chest_window)), M))
            continue
        pairs = torch.stack([0.5 * (ls[..., 0::2] + port_comb(lay)[1] * ls[..., 1::2])
                             for lay in ports], dim=2)             # (n, R, Pg, M/4)
        d = pairs[..., 1:] - pairs[..., :-1]
        terms.append((d.abs() ** 2).mean(-1))                      # (n, R, Pg)
        sm = q(nr._moving_average(pairs.repeat_interleave(2, dim=-1), p.chest_window))
        hg = q(interp(sm, M))                                      # (n, R, Pg, M)
        for i, lay in enumerate(ports):
            h[lay] = hg[:, :, i]
    # the pairs average the DMRS symbols: scaled back to one symbol's
    nvar = q(torch.cat(terms, dim=-1).mean((1, 2)) * len(p.dmrs_symbols)) if terms else None
    return torch.stack(h, dim=2), nvar


def equalize(h: torch.Tensor, yd: torch.Tensor, nvar, q: nr.Quantize = nr.exact) -> tuple:
    """h (n, R, L, M), the data REs yd (n, R, S, M) -> (x (n, L, S, M),
    mag (n, L, 1, M)): MRC at one layer, else the MMSE per subcarrier."""
    if h.shape[2] == 1:
        x = q((h.conj()[:, :, 0, None] * yd).sum(1))[:, None]
        mag = q((h.abs() ** 2).sum(1))[:, :, None]
        return x, mag
    H = h.permute(0, 3, 1, 2)                                      # (n, M, R, L)
    Hh = H.conj().transpose(-1, -2)                                # (n, M, L, R)
    G = q(Hh @ H)                                                  # (n, M, L, L)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    A = G + nvar[:, None, None, None] * eye
    b = q(Hh @ yd.permute(0, 3, 1, 2))                             # (n, M, L, S)
    x = q(torch.linalg.solve(A, b)).permute(0, 2, 3, 1)            # (n, L, S, M)
    mag = torch.diagonal(torch.linalg.solve(A, G), dim1=-2, dim2=-1).real
    return x, q(mag.transpose(1, 2))[:, :, None]


def maxlog(x: torch.Tensor, mag: torch.Tensor, qm: int) -> list:
    """The qm LLR planes of the compensated symbols, as nr.frontend_llrs forms them."""
    re, im, mag = x.real, x.imag, mag.expand(x.shape)
    if qm == 2:
        return [re / np.sqrt(2), im / np.sqrt(2)]
    if qm == 4:
        t = 2 / np.sqrt(10) * mag
        return [re, im, t - re.abs(), t - im.abs()]
    if qm == 6:
        t4, t2 = 4 / np.sqrt(42) * mag, 2 / np.sqrt(42) * mag
        b2, b3 = t4 - re.abs(), t4 - im.abs()
        return [re, im, b2, b3, t2 - b2.abs(), t2 - b3.abs()]
    raise ValueError(f"Qm {qm}")


@float32_matmul
def frontend_llrs(p: nr.Pusch, rx: torch.Tensor, q: nr.Quantize = nr.exact) -> torch.Tensor:
    """(n, rx, samples) -> (n, G) descrambled codeword LLRs."""
    n = rx.shape[0]
    y = q(nr.ofdm_demodulate(p, rx))                               # (n, R, 14, M)
    h, nvar = estimate(p, y, q)
    x, mag = equalize(h, y[:, :, p.data_symbols], nvar, q)
    llr = q(torch.stack(maxlog(x, mag, p.qm), dim=-1).float())     # (n, L, S, M, qm)
    llr = llr.permute(0, 2, 3, 1, 4).reshape(n, p.G)               # (RE, layer, bit)
    c = torch.as_tensor(nr.gold(nr.data_cinit(p), p.G), device=rx.device).float()
    return llr * (1 - 2 * c)


def recover(p: nr.Pusch, llr_cw: torch.Tensor) -> torch.Tensor:
    """(n, G) codeword LLRs -> (n C, cols Z) float32 decoder input:
    ``nr.recover``'s buffer, which that function hands on in bfloat16 (the
    input K3's path stages), here in the float32 the eager frontend hands
    K1."""
    s, qm, g = p.seg, p.qm, nr.graph(p.seg.bg, p.seg.Z)
    n = llr_cw.shape[0]
    buf = torch.zeros((n, s.C, g.cols * s.Z), dtype=torch.float32, device=llr_cw.device)
    buf[:, :, g.kc * s.Z - s.F: g.kc * s.Z] = nr.FILLER_LLR
    off = 0
    for j, E in enumerate(p.es):
        e = llr_cw[:, off: off + E].reshape(n, E // qm, qm).transpose(1, 2).reshape(n, E)
        sel = torch.as_tensor(nr.selection(s.bg, s.Z, s.F, E) + 2 * s.Z, device=llr_cw.device)
        buf[:, j].index_add_(1, sel, e)
        off += E
    return buf.reshape(n * s.C, -1)


def receive(p: nr.Pusch, rx: torch.Tensor, q: nr.Quantize = nr.exact) -> dict:
    """The whole plain receiver over (n, rx, samples): the dict of
    ``nr.receive`` (LLRs, decoded bits, flags, iterations)."""
    llr = frontend_llrs(p, rx, q)
    g = nr.graph(p.seg.bg, p.seg.Z)
    bits, ok, iters = nr.decode(g, recover(p, llr), p.n_iters, p.check_every)
    tb, tb_ok = nr.desegment(p, bits)
    C = p.seg.C
    return {"llrs": llr, "tb_bits": tb, "tb_ok": tb_ok, "cb_ok": ok.reshape(-1, C),
            "iters": iters.reshape(-1, C)}

