"""3GPP constant tables: LDPC lifting sizes and base graphs, the polar
reliability sequence (TS 38.212), PUSCH DMRS positions (TS 38.211).

The port's own copy of the part of openairinterface5g_tpu/data/tables.py it
uses, so that it imports nothing of the JAX package.  ``spec_tables.npz``
beside this file is a byte copy of that package's file:
  - ``bg1``: (8, 46, 68) int16 — Table 5.3.2-2 shift values per lifting set,
    -1 marks "no edge".
  - ``bg2``: (8, 42, 52) int16 — Table 5.3.2-3.
  - ``polar_q1024``: (1024,) — Table 5.3.1.2-1, ascending reliability.
tests/test_torch_pusch.py holds the LDPC tables and the polar sequence
against the original, tests/test_torch_sim.py the DMRS positions.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "spec_tables.npz")

# TS 38.212 Table 5.3.2-1: lifting sizes Z = a * 2^j grouped into 8 sets,
# indexed by iLS.  Shift used on the lifted graph is V(i,j) mod Z.
LIFTING_SETS: tuple[tuple[int, ...], ...] = (
    (2, 4, 8, 16, 32, 64, 128, 256),
    (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320),
    (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288),
    (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208),
    (15, 30, 60, 120, 240),
)

ALL_LIFTING_SIZES: tuple[int, ...] = tuple(sorted(z for s in LIFTING_SETS for z in s))

# Base-graph geometry (TS 38.212 5.2.2 / 5.3.2)
BG_INFO_COLS = {1: 22, 2: 10}      # Kb (max) systematic columns
BG_ROWS = {1: 46, 2: 42}
BG_COLS = {1: 68, 2: 52}
BG_KCB = {1: 8448, 2: 3840}        # max code block size


def lifting_set_index(Z: int) -> int:
    for ils, sizes in enumerate(LIFTING_SETS):
        if Z in sizes:
            return ils
    raise ValueError(f"{Z} is not a valid NR LDPC lifting size")


@functools.lru_cache(maxsize=1)
def _load_npz():
    return np.load(_NPZ)


@functools.lru_cache(maxsize=32)
def load_base_graph(bg: int, Z: int) -> np.ndarray:
    """Shift matrix for base graph `bg` at lifting size `Z`: (rows, cols)
    int16 with the shifts V(i,j) mod Z; -1 = no edge."""
    if bg not in (1, 2):
        raise ValueError("bg must be 1 or 2")
    tab = _load_npz()[f"bg{bg}"][lifting_set_index(Z)].astype(np.int32)
    return np.where(tab >= 0, tab % Z, -1).astype(np.int16)


@functools.lru_cache(maxsize=16)
def polar_reliability_sequence(N: int) -> np.ndarray:
    """Reliability sequence Q_0^{N-1} (ascending reliability) for N <= 1024:
    for N < 1024 the subsequence of Q^1024 with elements < N (TS 38.212
    §5.3.1.2)."""
    if N > 1024 or N & (N - 1):
        raise ValueError("N must be a power of two <= 1024")
    q = _load_npz()["polar_q1024"].astype(np.int32)
    return q[q < N].astype(np.int32)


# --- PUSCH DMRS symbol positions (TS 38.211 Table 6.4.1.1.3-3) --------------
# Single-symbol DMRS l-bar positions as symbol bitmasks, rows = ld-3
# (ld = 4..14, row 0 = ld<4), columns = [typeA pos0..3, typeB pos0..3].
# TypeA masks exclude l0 (OR'd in by the caller); typeB masks are relative
# to the allocation start.
PUSCH_DMRS_POS_L1 = (
    (-1, -1, -1, -1, 0x001, 0x001, 0x001, 0x001),   # ld < 4
    (0, 0, 0, 0, 0x001, 0x001, 0x001, 0x001),       # 4
    (0, 0, 0, 0, 0x001, 0x011, 0x011, 0x011),       # 5
    (0, 0, 0, 0, 0x001, 0x011, 0x011, 0x011),       # 6
    (0, 0, 0, 0, 0x001, 0x011, 0x011, 0x011),       # 7
    (0, 0x080, 0x080, 0x080, 0x001, 0x041, 0x049, 0x049),   # 8
    (0, 0x080, 0x080, 0x080, 0x001, 0x041, 0x049, 0x049),   # 9
    (0, 0x200, 0x240, 0x240, 0x001, 0x101, 0x111, 0x249),   # 10
    (0, 0x200, 0x240, 0x240, 0x001, 0x101, 0x111, 0x249),   # 11
    (0, 0x200, 0x240, 0x920, 0x001, 0x401, 0x421, 0x249),   # 12
    (0, 0x800, 0x880, 0x920, 0x001, 0x401, 0x421, 0x249),   # 13
    (0, 0x800, 0x880, 0x920, 0x001, 0x401, 0x421, 0x249),   # 14
)


def pusch_dmrs_symbols(mapping_type: str, add_pos: int, start_symbol: int,
                       n_symbols: int, typea_pos: int = 2) -> tuple:
    """DMRS symbol indices for single-symbol PUSCH DMRS (38.211 6.4.1.1.3).

    mapping_type: 'A' (ld counted from slot start, l0 = typea_pos) or
    'B' (ld = allocation duration, positions relative to start_symbol)."""
    ld = (start_symbol + n_symbols) if mapping_type == "A" else n_symbols
    row = 0 if ld < 4 else ld - 3
    col = add_pos + (4 if mapping_type == "B" else 0)
    mask = PUSCH_DMRS_POS_L1[row][col]
    if mask < 0:
        raise ValueError(f"invalid DMRS config ld={ld} type{mapping_type}")
    if mapping_type == "A":
        mask |= 1 << typea_pos
        return tuple(s for s in range(14) if (mask >> s) & 1)
    return tuple(start_symbol + s for s in range(14) if (mask >> s) & 1)
