"""Fronthaul split formats (RU <-> L1 functional split, SURVEY.md C7).

A copy of openairinterface5g_tpu/fronthaul/__init__.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_runtime.py holds the two
codes equal.
"""
