"""VCD (value-change-dump) signal dumper — the
common/utils/LOG/vcd_signal_dumper.c analog.

The reference instruments function entry/exit and scalar variables with
VCD_SIGNAL_DUMPER_* macros and renders them in GTKWave.  Here a
VcdDumper records the same two signal classes (1-bit "functions", 64-bit
"variables") with microsecond timestamps and writes a standard $var/#t
VCD file any waveform viewer opens.

A copy of openairinterface5g_tpu/utils/vcd.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_utils.py holds the two
codes equal.
"""
from __future__ import annotations

import contextlib
import time


class VcdDumper:
    def __init__(self, path: str):
        self.path = path
        self._t0 = time.monotonic_ns()
        self._events: list[tuple[int, str, int]] = []   # (t_us, id, value)
        self._funcs: dict[str, str] = {}
        self._vars: dict[str, str] = {}
        self._next = 0

    def _sym(self) -> str:
        s = ""
        n = self._next
        self._next += 1
        while True:
            s += chr(33 + n % 94)
            n //= 94
            if n == 0:
                return s

    def _now_us(self) -> int:
        return (time.monotonic_ns() - self._t0) // 1000

    def function_start(self, name: str) -> None:
        sym = self._funcs.setdefault(name, self._sym())
        self._events.append((self._now_us(), sym, 1))

    def function_end(self, name: str) -> None:
        sym = self._funcs.setdefault(name, self._sym())
        self._events.append((self._now_us(), sym, 0))

    @contextlib.contextmanager
    def function(self, name: str):
        self.function_start(name)
        try:
            yield
        finally:
            self.function_end(name)

    def variable(self, name: str, value: int) -> None:
        sym = self._vars.setdefault(name, self._sym())
        self._events.append((self._now_us(), sym, int(value)))

    def write(self) -> str:
        lines = ["$timescale 1us $end", "$scope module functions $end"]
        for name, sym in self._funcs.items():
            lines.append(f"$var wire 1 {sym} {name} $end")
        lines.append("$upscope $end")
        lines.append("$scope module variables $end")
        for name, sym in self._vars.items():
            lines.append(f"$var integer 64 {sym} {name} $end")
        lines.append("$upscope $end")
        lines.append("$enddefinitions $end")
        var_syms = set(self._vars.values())
        for t, sym, v in sorted(self._events, key=lambda e: e[0]):
            lines.append(f"#{t}")
            if sym in var_syms:
                lines.append(f"b{v:b} {sym}")
            else:
                lines.append(f"{v}{sym}")
        with open(self.path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return self.path
