"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object, all of
them at once in parallel processes, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
built at first use into ``_build/`` beside the package (listed in
``.gitignore``); its file name carries a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.

The launch route.  ``route()`` binds, at the first launch, the library's
entry points, each with its ``argtypes`` (``c_void_p`` for every pointer
and the stream, so ctypes never cuts a pointer to 32 bits) and with the
GIL released around the call, and PyTorch's own accessor of the
current stream as a raw ``cudaStream_t``,
``torch._C._cuda_getCurrentRawStream`` (only CUDA builds of torch have it,
so it is never looked up at import).  A wrapper's launch path is then:
checks that are plain comparisons (a message is formatted only on
failure), the outputs from ``torch.empty``, and one ctypes call that takes
the tensors' device index and the raw stream.  The C side
(``csrc/launch.cuh``) switches the current device only where it differs,
raises a kernel's shared-memory limit only when a launch needs more than
before, launches on that stream (so it stays ordered with PyTorch's ops,
under ``torch.cuda.stream`` and in graph capture alike) and returns
``cudaGetLastError()``; a non-zero code raises ``error(rc, ...)``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# both LDPC decoders' entry points (csrc/ldpc_layered.cu, ldpc_flooding.cu)
_LDPC_DECODE = (
    _P, _I, _I,                    # llr, in_kind, msg_kind
    _P, _P, _P,                    # bits, ok, iterations run (or null)
    _P, _P,                        # state scratch, graph table
    _I, _I, _I, _I, _I, _I, _I,    # B, layers, rows, cols, E, Z, K
    _I, _I, _F, _I, _P)            # n_iters, check_every, alpha, device, stream
# C signatures of the entry points: name -> argtypes (restype is int).  Every
# entry point ends in (device index, stream).
_SIGNATURES = {
    "ldpc_layered_decode": _LDPC_DECODE,
    "ldpc_flooding_decode": _LDPC_DECODE,
    "pusch_frontend": (
        _P, _P, _P, _P,                # y, pilots, packed scrambling signs, planes
        _I, _I, _I, _I, _I, _I,        # B, R, P, n_sym, n_sc, a0
        _I, _I, _I, _I, _I, _I,        # n_prb, delta, n_dmrs, n_data, qm, window
        _I, _I,                        # DMRS and data symbol masks
        _I, _I, _I, _I, _I, _I, _I,    # C, r_grp, s_buf, tile_cap, ls_cap, hs_cap, smem
        _I, _P),                       # device, stream
    "pusch_frontend_clusters": (
        _I, _I, _I, _I, _P,            # P, qm, C, smem, active (int out)
        _I, _P),                       # device, stream (unused)
    "tiny_times_two": (_P, _P, _I, _I, _P),  # x, out, n_blocks, device, stream
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if no build of the current sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    so = BUILD_DIR / f"liboai5g_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [(src.name, proc.communicate()[0], proc.returncode)
                for src, proc in zip(sources(), procs)]
        failed = [f"{name} ({rc}):\n{log}" for name, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = Path(work) / so.name
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)             # atomic: concurrent builds agree
    return so


_ROUTE = None


def route() -> types.SimpleNamespace:
    """The launch route, bound at its first call (which builds the library):
    one attribute per C entry point of ``_SIGNATURES``, and ``stream(index)``,
    PyTorch's current stream on CUDA device ``index`` as a raw handle."""
    return _ROUTE if _ROUTE is not None else _bind()


def _bind() -> types.SimpleNamespace:
    global _ROUTE
    # CDLL releases the GIL around each call: a launch can block (a full
    # launch queue, a kernel module's first load on a device)
    lib = ctypes.CDLL(str(build()))
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    _ROUTE = types.SimpleNamespace(lib=lib, stream=torch._C._cuda_getCurrentRawStream, **fns)
    return _ROUTE


def error(rc: int, what: str) -> RuntimeError:
    """The exception for a non-zero cudaError_t returned by a launch."""
    return RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
