"""Python binding for the native rfsim IQ-exchange transport.

The radio-HAL layer analog (radio/COMMON/common_lib.h openair0_device
vtable + radio/rfsimulator): `RfSimDevice.read/write` mirror
trx_read_func/trx_write_func with sample timestamps.  The heavy lifting
(sockets, framing, timestamp-aligned ring buffering) is the C++ shared
lib in native/rfsim, loaded via ctypes; samples cross the boundary as
numpy complex64 arrays.

Port of openairinterface5g_tpu/radio/rfsim.py: the same code but for where
the library comes from.  The port compiles native/rfsim/rfsim.cpp itself,
with the hub's Makefile flags (-O2 -std=c++17 -fPIC -Wall -Wextra -shared
-lpthread), at first use into _build/ beside the package (as ops/_cuda.py
builds the kernels), under a name that hashes the source and flags, so an
edited source rebuilds.  A failed build raises; the checked-in
native/rfsim/librfsim.so is never loaded or rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "rfsim" / "rfsim.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (CXX, g++ or c++) to build the rfsim hub")


def build() -> Path:
    """Compile the hub into _build/ unless a build of this source exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"librfsim_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / so.name
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the rfsim hub failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)             # atomic: concurrent builds agree
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.rfsim_listen.restype = ctypes.c_void_p
        lib.rfsim_listen.argtypes = [ctypes.c_uint16, ctypes.c_uint32]
        lib.rfsim_connect.restype = ctypes.c_void_p
        lib.rfsim_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                      ctypes.c_uint32, ctypes.c_int]
        lib.rfsim_write.restype = ctypes.c_int
        lib.rfsim_write.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
        lib.rfsim_read.restype = ctypes.c_int
        lib.rfsim_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
        lib.rfsim_close.argtypes = [ctypes.c_void_p]
        lib.rfsim_set_channel.restype = ctypes.c_int
        lib.rfsim_set_channel.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_uint32, ctypes.c_float]
        lib.rfsim_record.restype = ctypes.c_int
        lib.rfsim_record.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_uint64]
        lib.rfsim_replay.restype = ctypes.c_int64
        lib.rfsim_replay.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_uint64]
        _lib = lib
    return _lib


class RfSimDevice:
    """One endpoint of an IQ link (openair0_device analog)."""

    def __init__(self, handle, n_ant: int):
        self._h = handle
        self.n_ant = n_ant

    @classmethod
    def listen(cls, port: int, n_ant: int = 1) -> "RfSimDevice":
        lib = _load()
        h = lib.rfsim_listen(port, n_ant)
        if not h:
            raise OSError(f"rfsim_listen({port}) failed")
        return cls(h, n_ant)

    @classmethod
    def connect(cls, host: str, port: int, n_ant: int = 1,
                timeout_ms: int = 5000) -> "RfSimDevice":
        lib = _load()
        h = lib.rfsim_connect(host.encode(), port, n_ant, timeout_ms)
        if not h:
            raise OSError(f"rfsim_connect({host}:{port}) failed")
        return cls(h, n_ant)

    def write(self, timestamp: int, samples: np.ndarray) -> None:
        """samples: (n_ant, n) or (n,) complex64 (trx_write_func analog)."""
        s = np.ascontiguousarray(
            np.atleast_2d(samples).astype(np.complex64).T)  # (n, n_ant)
        n = s.shape[0]
        f = s.view(np.float32)
        rc = _load().rfsim_write(
            self._h, timestamp, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        if rc != 0:
            raise OSError("rfsim_write failed")

    def read(self, timestamp: int, n_samples: int) -> np.ndarray:
        """Blocking read of (n_ant, n_samples) complex64 at `timestamp`."""
        buf = np.zeros((n_samples, self.n_ant), np.complex64)
        f = buf.view(np.float32)
        rc = _load().rfsim_read(
            self._h, timestamp, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_samples)
        if rc != 0:
            raise OSError("rfsim_read: peer closed before data available")
        return buf.T.copy()

    def set_channel(self, taps: np.ndarray | None,
                    noise_sigma: float = 0.0) -> None:
        """Apply a channel model to RECEIVED samples inside the native hub
        (the rfsimulator `rfsimu_setchanmod_cmd` telnet-command analog,
        radio/rfsimulator/apply_channelmod.c): static complex FIR `taps`
        + AWGN with per-component std `noise_sigma`.  taps=None clears."""
        lib = _load()
        if taps is None:
            rc = lib.rfsim_set_channel(self._h, None, 0, 0.0)
        else:
            t = np.ascontiguousarray(np.atleast_1d(taps).astype(np.complex64))
            f = t.view(np.float32)
            rc = lib.rfsim_set_channel(
                self._h, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                t.size, float(noise_sigma))
        if rc != 0:
            raise OSError("rfsim_set_channel failed")

    def close(self):
        if self._h:
            _load().rfsim_close(self._h)
            self._h = None


def record_iq(path: str, samples: np.ndarray) -> None:
    """iqplayer-analog capture: write complex64 samples to file."""
    s = np.ascontiguousarray(samples.astype(np.complex64)).view(np.float32)
    rc = _load().rfsim_record(path.encode(),
                              s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              s.size)
    if rc != 0:
        raise OSError("rfsim_record failed")


def replay_iq(path: str, n_samples: int) -> np.ndarray:
    buf = np.zeros(n_samples, np.complex64)
    f = buf.view(np.float32)
    n = _load().rfsim_replay(path.encode(),
                             f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             f.size)
    if n < 0:
        raise OSError("rfsim_replay failed")
    return buf[: n // 2]
