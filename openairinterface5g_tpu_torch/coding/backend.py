"""LDPC decoder registry.

Port of openairinterface5g_tpu/coding/backend.py.  Both entries share one
signature, (graph, llr, n_iters, **kw) -> (bits, ok):

  'reference' — flooding min-sum in PyTorch (coding/ldpc.py::decode), the
                reference schedule; stops once every code block passes
  'kernel'    — min-sum CUDA kernel (ops/ldpc_decoder.py; its plain PyTorch
                version for CPU tensors), layered or flooding (`schedule`),
                per-code-block early stop every `check_every` iterations
"""
from __future__ import annotations

from typing import Callable

from ..ops import ldpc_decoder
from . import ldpc


def _decode_reference(graph, llr, n_iters=12, **kw):
    bits, ok, _ = ldpc.decode(graph, llr, n_iters=n_iters)
    return bits, ok


def _decode_kernel(graph, llr, n_iters=8, **kw):
    return ldpc_decoder.decode(graph, llr, n_iters=n_iters,
                               schedule=kw.get("schedule", "layered"),
                               check_every=kw.get("check_every", 0))


_BACKENDS: dict[str, Callable] = {
    "reference": _decode_reference,
    "kernel": _decode_kernel,
}


def decoder(name: str) -> Callable:
    """Resolve a decode fn (graph, llr, n_iters, **kw) -> (bits, ok)."""
    if name not in _BACKENDS:
        raise KeyError(f"unknown LDPC backend {name!r}; have {sorted(_BACKENDS)}")
    return _BACKENDS[name]
