"""L2 of the port: MAC scheduler, RLC, PDCP with NEA2/NIA2, SDAP and the DRB user plane.

A copy of openairinterface5g_tpu/l2/__init__.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
from . import mac, pdcp, rlc, sdap  # noqa: F401
