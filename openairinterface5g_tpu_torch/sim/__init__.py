"""Link-level simulators of the port (openairinterface5g_tpu/sim analogs).

Each CLI takes ``--device cuda|cpu`` and runs on the card unless asked for
the CPU; ``resolve_device`` resolves the flag.
"""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The run's device; 'cuda' without a CUDA device raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a GPU, or pass --device cpu")
    return dev


def device_name(dev: torch.device) -> str:
    """What a result line names as its device."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
