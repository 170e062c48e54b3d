"""Schema-driven unaligned-PER (UPER) style bit codec.

The reference compiles 3GPP ASN.1 modules with asn1c into thousands of
generated C files (openair2/RRC/NR/MESSAGES, openair2/F1AP/MESSAGES,
openair3/NGAP).  Here messages are declared as Python schemas and
encoded with the same core UPER rules (X.691): constrained whole
numbers in ceil(log2(range)) bits, optional-presence bitmaps ahead of a
SEQUENCE, length-prefixed SEQUENCE OF / strings.  Extension containers
are modeled as a single present/absent bit (enough for the message set
used here; full X.691 extension encoding is out of scope).

A copy of openairinterface5g_tpu/l3/per.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_lte_stack.py holds the two
encodings equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def put(self, value: int, n_bits: int) -> None:
        assert 0 <= value < (1 << n_bits), (value, n_bits)
        for i in range(n_bits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def put_bytes(self, data: bytes) -> None:
        for b in data:
            self.put(b, 8)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        return bytes(
            sum(bits[i + j] << (7 - j) for j in range(8))
            for i in range(0, len(bits), 8))


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def get(self, n_bits: int) -> int:
        v = 0
        for _ in range(n_bits):
            byte = self._data[self._pos // 8]
            v = (v << 1) | ((byte >> (7 - self._pos % 8)) & 1)
            self._pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get(8) for _ in range(n))


# --- field kinds -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Int:
    """Constrained INTEGER [lo, hi]."""
    lo: int
    hi: int

    @property
    def bits(self) -> int:
        return max((self.hi - self.lo).bit_length(), 0)

    def enc(self, w: BitWriter, v: int) -> None:
        w.put(v - self.lo, self.bits)

    def dec(self, r: BitReader) -> int:
        return r.get(self.bits) + self.lo


@dataclasses.dataclass(frozen=True)
class Enum:
    """ENUMERATED over the given names."""
    names: tuple

    @property
    def bits(self) -> int:
        return max((len(self.names) - 1).bit_length(), 1)

    def enc(self, w: BitWriter, v: str) -> None:
        w.put(self.names.index(v), self.bits)

    def dec(self, r: BitReader) -> str:
        return self.names[r.get(self.bits)]


@dataclasses.dataclass(frozen=True)
class BitStr:
    """Fixed-length BIT STRING carried as an int."""
    n_bits: int

    def enc(self, w: BitWriter, v: int) -> None:
        w.put(v, self.n_bits)

    def dec(self, r: BitReader) -> int:
        return r.get(self.n_bits)


@dataclasses.dataclass(frozen=True)
class OctStr:
    """OCTET STRING, variable length with a 16-bit length determinant
    (covers the NAS-PDU / transport containers used here)."""
    max_len: int = 65535

    def enc(self, w: BitWriter, v: bytes) -> None:
        w.put(len(v), 16)
        w.put_bytes(v)

    def dec(self, r: BitReader) -> bytes:
        return r.get_bytes(r.get(16))


@dataclasses.dataclass(frozen=True)
class SeqOf:
    """SEQUENCE OF with 8-bit count."""
    inner: Any

    def enc(self, w: BitWriter, v: list) -> None:
        w.put(len(v), 8)
        for item in v:
            self.inner.enc(w, item)

    def dec(self, r: BitReader) -> list:
        return [self.inner.dec(r) for _ in range(r.get(8))]


@dataclasses.dataclass(frozen=True)
class Seq:
    """SEQUENCE: [(name, kind, optional), ...] -> dict codec.

    Presence bitmap for optional fields first (X.691 §19.2-19.3).
    """
    fields: tuple

    def enc(self, w: BitWriter, v: dict) -> None:
        opts = [f for f in self.fields if f[2]]
        for name, _, _ in opts:
            w.put(1 if v.get(name) is not None else 0, 1)
        for name, kind, optional in self.fields:
            val = v.get(name)
            if optional and val is None:
                continue
            kind.enc(w, val)

    def dec(self, r: BitReader) -> dict:
        opts = [f for f in self.fields if f[2]]
        present = {name: bool(r.get(1)) for name, _, _ in opts}
        out = {}
        for name, kind, optional in self.fields:
            if optional and not present.get(name, False):
                out[name] = None
                continue
            out[name] = kind.dec(r)
        return out


@dataclasses.dataclass(frozen=True)
class Choice:
    """CHOICE over [(name, kind), ...]."""
    alts: tuple

    @property
    def bits(self) -> int:
        return max((len(self.alts) - 1).bit_length(), 1)

    def enc(self, w: BitWriter, v: tuple) -> None:
        name, val = v
        idx = [a[0] for a in self.alts].index(name)
        w.put(idx, self.bits)
        self.alts[idx][1].enc(w, val)

    def dec(self, r: BitReader) -> tuple:
        idx = r.get(self.bits)
        name, kind = self.alts[idx]
        return name, kind.dec(r)


def encode(schema, value) -> bytes:
    w = BitWriter()
    schema.enc(w, value)
    return w.to_bytes()


def decode(schema, data: bytes):
    return schema.dec(BitReader(data))
