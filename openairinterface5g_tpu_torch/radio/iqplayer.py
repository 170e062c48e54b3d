"""IQ record/replay radio device (the reference's radio/iqplayer +
doc/iqrecordplayer_usage.md analog).

Presents the same read/write surface as RfSimDevice so the softmodem
loop can run against captured IQ instead of a live link: `write` appends
to the capture, `read` serves timestamp-aligned samples from the loaded
recording (wrapping at the end like the reference's circular playback).
File format: raw interleaved float32 I/Q (complex64), one stream per
antenna saved side-by-side — the same layout native/rfsim record/replay
uses.

A copy of openairinterface5g_tpu/radio/iqplayer.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from __future__ import annotations

import os

import numpy as np

from .rfsim import record_iq, replay_iq


class IQPlayerDevice:
    """openair0_device-style record/replay endpoint."""

    def __init__(self, path: str, n_ant: int = 1, mode: str = "replay",
                 n_samples: int | None = None):
        self.path = path
        self.n_ant = n_ant
        self.mode = mode
        self._buf: np.ndarray | None = None
        self._written: list[np.ndarray] = []
        if mode == "replay":
            if n_samples is None:
                n_samples = os.path.getsize(path) // 8 // n_ant
            flat = replay_iq(path, n_samples * n_ant)
            self._buf = flat.reshape(n_ant, n_samples)

    def read(self, timestamp: int, n_samples: int) -> np.ndarray:
        """(n_ant, n_samples) complex64 at `timestamp`, circular."""
        assert self._buf is not None, "device opened for record"
        N = self._buf.shape[1]
        idx = (timestamp + np.arange(n_samples)) % N
        return self._buf[:, idx]

    def write(self, timestamp: int, samples: np.ndarray) -> None:
        self._written.append(np.asarray(samples, np.complex64))

    def close(self) -> None:
        if self.mode == "record" and self._written:
            record_iq(self.path, np.concatenate(self._written, axis=-1).ravel())
