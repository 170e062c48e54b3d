"""Carry configuration and state from the JAX package to this port.

A RAN PHY has no learned weights: what crosses over is the PUSCH
configuration, the channel description and the HARQ soft buffer.  The
JAX objects are read through plain Python and numpy, so this module
imports no JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.pdsch import Pdsch2CwConfig, PdschConfig
from .models.pusch import PuschConfig
from .sim.channel import ChannelModel

DECODER_BACKENDS = {"xla": "reference", "pallas": "kernel"}
FRONTEND_BACKENDS = {"auto": "auto", "xla": "reference", "pallas": "kernel"}


_CONFIGS = {"PuschConfig": PuschConfig, "PdschConfig": PdschConfig,
            "Pdsch2CwConfig": Pdsch2CwConfig}


def config_from_jax(jax_cfg):
    """The port's configuration for a JAX ``PuschConfig``, ``PdschConfig`` or
    ``Pdsch2CwConfig`` (the port's class of the same name); the backend
    names map xla -> reference and pallas -> kernel."""
    fields = dataclasses.asdict(jax_cfg)
    fields["decoder_backend"] = DECODER_BACKENDS[fields["decoder_backend"]]
    if "frontend_backend" in fields:
        fields["frontend_backend"] = FRONTEND_BACKENDS[fields["frontend_backend"]]
    return _CONFIGS[type(jax_cfg).__name__](**fields)


def channel_model_from_jax(jax_model) -> ChannelModel:
    """The port's ChannelModel for a JAX ``sim.channel.ChannelModel``."""
    return ChannelModel(**dataclasses.asdict(jax_model))


def harq_from_numpy(arr: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """A JAX HARQ soft buffer (B, C, cols*Z), given as numpy, as a tensor on
    `device` with the same dtype (float32, or bfloat16 when the JAX receiver
    staged it so)."""
    a = np.array(arr)                   # a writable copy
    if a.dtype.name == "bfloat16":      # numpy has no bf16: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)
