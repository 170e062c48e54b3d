"""3GPP TS 38.212 LDPC constant tables: lifting sizes and base graphs.

The port's own copy of the part of openairinterface5g_tpu/data/tables.py it
uses, so that it imports nothing of the JAX package.  ``spec_tables.npz``
beside this file is a byte copy of that package's file:
  - ``bg1``: (8, 46, 68) int16 — Table 5.3.2-2 shift values per lifting set,
    -1 marks "no edge".
  - ``bg2``: (8, 42, 52) int16 — Table 5.3.2-3.
tests/test_torch_pusch.py holds every table here against the original.
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
