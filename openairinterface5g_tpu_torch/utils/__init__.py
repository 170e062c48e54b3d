"""Utilities of the port: per-stage timing, the program's tracer (spans
and counters of the uplink path, read by the benchmark's per-layer
metrics) and CUDA profiling (utils/profiling.py), the live web scope
(utils/webscope.py), and copies of the JAX package's host utilities (the
libconfig-style configuration module, component logging, the T-tracer
analog, the ITTI-style bus, the telnet control server and the VCD
dumper), which tests/test_torch_utils.py holds equal to the originals.
"""
