"""T-tracer analog: typed event ring with binary record/replay.

The reference's T tracer (common/utils/T/T.h:112-140) writes typed events
into a lock-free shared-memory ring; external tools record to file,
replay, and plot (T/tracer/record.c, replay.c).  Event ids and shapes
come from T_messages.txt.

Here: a process-local ring of typed events (id registry below), binary
save/load for record/replay, and numpy payloads for IQ/LLR dumps — the
same three capabilities (live ring, record, replay) minus the shm
transport, which a single-process host runtime does not need.

A copy of openairinterface5g_tpu/utils/ttrace.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_utils.py holds the two
codes equal.
"""
from __future__ import annotations

import collections
import dataclasses
import io
import struct
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np

# event registry (T_messages.txt analog): id -> (name, field names)
EVENTS = {
    1: ("GNB_PHY_UL_TIME", ("sfn", "slot")),
    2: ("GNB_PHY_PUSCH_IQ", ("sfn", "slot", "rnti")),
    3: ("GNB_PHY_PUSCH_LLR", ("sfn", "slot", "rnti")),
    4: ("GNB_PHY_DL_OUTPUT_SIGNAL", ("sfn", "slot")),
    5: ("GNB_MAC_SCHED", ("sfn", "slot", "rnti", "mcs", "prbs")),
    6: ("GNB_PHY_CRC", ("sfn", "slot", "rnti", "ok")),
    7: ("UE_PHY_MEAS", ("sfn", "slot", "rsrp_dbm_x100")),
}
_BY_NAME = {name: eid for eid, (name, _) in EVENTS.items()}


@dataclasses.dataclass
class Event:
    eid: int
    t: float
    fields: tuple
    payload: Optional[np.ndarray] = None

    @property
    def name(self) -> str:
        return EVENTS[self.eid][0]


class Tracer:
    """Bounded event ring (the shm ring analog); thread-safe."""

    def __init__(self, capacity: int = 65536):
        self.ring: collections.deque[Event] = collections.deque(maxlen=capacity)
        self.enabled: set[int] = set(EVENTS)
        self._lock = threading.Lock()
        self.dropped = 0

    def enable_only(self, *names: str):
        self.enabled = {_BY_NAME[n] for n in names}

    def T(self, name: str, *fields, payload: Optional[np.ndarray] = None):
        """Emit an event (the T(T_ID, ...) macro analog)."""
        eid = _BY_NAME[name]
        if eid not in self.enabled:
            return
        ev = Event(eid, time.monotonic(), tuple(int(f) for f in fields),
                   None if payload is None else np.asarray(payload))
        with self._lock:
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(ev)

    def events(self, name: Optional[str] = None) -> list[Event]:
        with self._lock:
            evs = list(self.ring)
        if name is not None:
            eid = _BY_NAME[name]
            evs = [e for e in evs if e.eid == eid]
        return evs

    # ---- record / replay (tracer/record.c + replay.c analog) ----

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(b"T5GT\x01")
            for ev in self.events():
                _write_event(f, ev)

    @staticmethod
    def load(path: str) -> Iterator[Event]:
        with open(path, "rb") as f:
            magic = f.read(5)
            if magic != b"T5GT\x01":
                raise ValueError("not a trace file")
            while True:
                ev = _read_event(f)
                if ev is None:
                    return
                yield ev


_EHDR = struct.Struct("<HdHB")       # eid, t, n_fields, has_payload


def _write_event(f, ev: Event):
    f.write(_EHDR.pack(ev.eid, ev.t, len(ev.fields),
                       0 if ev.payload is None else 1))
    f.write(struct.pack(f"<{len(ev.fields)}q", *ev.fields))
    if ev.payload is not None:
        buf = io.BytesIO()
        np.save(buf, ev.payload, allow_pickle=False)
        raw = buf.getvalue()
        f.write(struct.pack("<I", len(raw)))
        f.write(raw)


def _read_event(f) -> Optional[Event]:
    hdr = f.read(_EHDR.size)
    if len(hdr) < _EHDR.size:
        return None
    eid, t, n, has_p = _EHDR.unpack(hdr)
    fields = struct.unpack(f"<{n}q", f.read(8 * n))
    payload = None
    if has_p:
        (ln,) = struct.unpack("<I", f.read(4))
        payload = np.load(io.BytesIO(f.read(ln)), allow_pickle=False)
    return Event(eid, t, fields, payload)


# module-level default tracer (the compiled-in T() macro target)
tracer = Tracer()
T = tracer.T
