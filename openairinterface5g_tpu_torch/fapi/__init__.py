"""FAPI of the port: the P5/P7 message codec and the PNF/VNF UDP transport.

A copy of openairinterface5g_tpu/fapi/__init__.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from . import messages, transport  # noqa: F401
