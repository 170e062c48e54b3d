"""Runtime loops of the port that drive the PHY (openairinterface5g_tpu/runtime
analogs): the slot executor, the nr-softmodem and UE softmodem loops, the
over-the-air RA and connected-mode endpoints over the rfsim hub, the IF4p5
RU/L1 split and the lte-softmodem loop."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..phy.ofdm import extract_from_grid, ofdm_demodulate


def endpoint_stream(device: torch.device):
    """A context that runs an endpoint's work on a CUDA stream of its own
    (two endpoints that share a card in one process keep their work apart);
    nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device=device))


def to_numpy(x: torch.Tensor):
    """A tensor's values as a numpy array (a host read: it waits for the
    device)."""
    return x.detach().cpu().numpy()


def re_grid(fp, samples: np.ndarray, slot: int, device: torch.device) -> torch.Tensor:
    """(n_ant, S) samples read off the hub -> (1, n_ant, symbols, n_sc) RE
    grid on `device` (CP removal, FFT, the BWP's subcarriers)."""
    return extract_from_grid(fp, ofdm_demodulate(
        fp, torch.as_tensor(samples[None], device=device), slot))
