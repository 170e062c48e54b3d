"""Component-scoped logging (common/utils/LOG analog).

The reference's LOG_I/D/E macros carry a component id (PHY, MAC, RLC,
PDCP, RRC, ...) with per-component runtime levels configurable from the
config file's `log_config` section.  This wraps the stdlib logging module
with the same surface: per-component loggers, a `set_level(comp, lvl)`
runtime knob (telnet-settable), and the matrix-style dump the reference
prints at startup.

A copy of openairinterface5g_tpu/utils/log.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_utils.py holds the two
codes equal.
"""
from __future__ import annotations

import logging
import sys

COMPONENTS = ("PHY", "MAC", "RLC", "PDCP", "SDAP", "RRC", "FAPI", "SIM",
              "HW", "UTIL")

_LEVELS = {"error": logging.ERROR, "warn": logging.WARNING,
           "info": logging.INFO, "debug": logging.DEBUG,
           "trace": logging.DEBUG - 5}

_loggers: dict[str, logging.Logger] = {}
_handler: logging.Handler | None = None


def _ensure_handler() -> logging.Handler:
    global _handler
    if _handler is None:
        _handler = logging.StreamHandler(sys.stderr)
        _handler.setFormatter(logging.Formatter(
            "[%(name)s] %(levelname).1s %(message)s"))
    return _handler


def get_logger(component: str) -> logging.Logger:
    comp = component.upper()
    if comp not in _loggers:
        lg = logging.getLogger(f"oai5g_tpu.{comp}")
        lg.addHandler(_ensure_handler())
        lg.propagate = False
        lg.setLevel(logging.INFO)
        _loggers[comp] = lg
    return _loggers[comp]


def set_level(component: str, level: str):
    get_logger(component).setLevel(_LEVELS[level.lower()])


def configure(log_config: dict):
    """Apply a `log_config` section: {global_log_level, <comp>_log_level}."""
    glob = log_config.get("global_log_level")
    if glob:
        for c in COMPONENTS:
            set_level(c, glob)
    for key, val in log_config.items():
        if key.endswith("_log_level") and key != "global_log_level":
            set_level(key[: -len("_log_level")], val)


def dump_levels() -> str:
    rows = []
    for c in COMPONENTS:
        lvl = logging.getLevelName(get_logger(c).level)
        rows.append(f"{c:6s} {lvl}")
    return "\n".join(rows)
