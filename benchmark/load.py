"""The benchmark's load generator, driven by a traffic file.

A traffic file (``benchmark/traffic/<name>.json``) gives:

- ``slots_per_call``: slots the program takes in one call;
- ``pool_calls``: distinct calls made in set-up (by the cell's path,
  ``benchmark/paths/<path>.py::make_pool``, from the run's seed on the
  device, with the path's own keys of the file, such as ``pusch_rx``'s
  ``channel``); the window cycles through them, so every call reads data
  no cache holds;
- ``depth``: calls in flight in the slot executor;
- ``loop``: ``closed`` (the next call as soon as the executor takes it) or
  ``open`` (one call due every ``period_ms``, whatever came back).

The same seed gives the same pool and the same sampled calls.
"""
from __future__ import annotations

import random
import time
from typing import Iterator

from .paths.pusch_rx import make_pool  # noqa: F401  the name from before benchmark/paths/


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
