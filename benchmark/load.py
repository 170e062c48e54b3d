"""The benchmark's one load generator, driven by a traffic file.

A traffic file (``benchmark/traffic/<name>.json``) gives:

- ``slots_per_call``: slots the program receives in one call;
- ``pool_calls``: distinct calls made in set-up; the window cycles through
  them, so every call reads samples no cache holds;
- ``depth``: calls in flight in the slot executor;
- ``channel``: ``cross`` (each receive antenna hears its layer, repeated
  over the antennas, plus ``cross`` times the layer of the antenna in
  mirror position) and ``noise_std`` (per real dimension of a sample);
- ``loop``: ``closed`` (the next call as soon as the executor takes it) or
  ``open`` (one call due every ``period_ms``, whatever came back).

Everything random comes from one ``torch.Generator`` on the device, seeded
with the run's seed: the same seed gives the same transport blocks, noise
and sampled calls.
"""
from __future__ import annotations

import random
import time
from typing import Iterator

import torch

from . import nr


def channel_matrix(n_rx: int, n_layers: int, cross: float) -> torch.Tensor:
    """(n_rx, n_layers): antenna r hears layer r mod L, and `cross` times
    the layer that antenna n_rx - 1 - r hears."""
    e = torch.zeros((n_rx, n_layers))
    e[torch.arange(n_rx), torch.arange(n_rx) % n_layers] = 1.0
    return e + cross * e.flip(0)


def make_pool(p: nr.Pusch, traffic: dict, seed: int, device: torch.device):
    """(pool of (slots, n_rx, samples) complex64 calls, their (slots, A)
    transport blocks), made on the device in one pass per call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B, ch = traffic["slots_per_call"], traffic["channel"]
    h = channel_matrix(p.n_rx, p.n_layers, ch["cross"]).to(device=device, dtype=torch.complex64)
    pool, blocks = [], []
    for _ in range(traffic["pool_calls"]):
        tb = torch.randint(0, 2, (B, p.A), generator=gen, device=device, dtype=torch.int8)
        tx = nr.transmit(p, tb)                                        # (B, L, S)
        rx = torch.einsum("rl,bls->brs", h, tx)
        noise = torch.randn((2, *rx.shape), generator=gen, device=device)
        rx = rx + ch["noise_std"] * torch.complex(noise[0], noise[1])
        pool.append(rx.contiguous())
        blocks.append(tb)
    return pool, blocks


def sampled_calls(seed: int, pool_calls: int, n: int) -> list:
    """The window's calls whose outputs the check keeps: n distinct call
    indices among the first two passes over the pool, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(2 * pool_calls), n))


def closed(pool: list, seconds: float, start: int = 0) -> Iterator[tuple]:
    """Calls as fast as the executor takes them, until `seconds` have
    passed since the first; call k reads pool[(start + k) % len(pool)]."""
    end = time.perf_counter() + seconds
    k = start
    while time.perf_counter() < end:
        yield (pool[k % len(pool)],)
        k += 1


def open_loop(pool: list, seconds: float, period_s: float, due: list, handed: list,
              start: int = 0) -> Iterator[tuple]:
    """Call k due at the first call's time + k period, for as many periods
    as fit in `seconds`; each is handed in at its due time, or at once
    where the executor takes it late.  Appends each call's due and
    handed-in times; call k reads pool[(start + k) % len(pool)]."""
    t0 = time.perf_counter()
    for k in range(int(seconds / period_s)):
        t_due = t0 + k * period_s
        now = time.perf_counter()
        if t_due - now > 0.0006:
            time.sleep(t_due - now - 0.0005)
        while (now := time.perf_counter()) < t_due:
            pass
        due.append(t_due)
        handed.append(now)
        yield (pool[(start + k) % len(pool)],)
