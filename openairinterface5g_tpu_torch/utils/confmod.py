"""Unified config module (common/config analog): libconfig-style files +
command-line overrides resolved against typed parameter descriptors.

The reference's config module (config_load_configmodule.c, config_userapi.c)
reads libconfig files, overlays `--section.param value` command-line args,
and hands modules their values via paramdef_t tables with defaults and
type checking.  This is the same contract in ~150 lines: a small parser
for the libconfig subset OAI uses (nested sections, scalars, strings,
lists), ParamDef tables with defaults/required/type, and the same
`-O file:dbgl<level>` entry point shape.

A copy of openairinterface5g_tpu/utils/confmod.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_utils.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional


# ---------------------------------------------------------------------------
# libconfig-subset parser: sections { }, name = value; lists ( ... ) / [ ... ]
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/) |
    (?P<str>"(?:[^"\\]|\\.)*") |
    (?P<num>0x[0-9a-fA-F]+|-?\d+\.\d+(?:[eE][-+]?\d+)?|-?\d+) |
    (?P<bool>\btrue\b|\bfalse\b) |
    (?P<name>[A-Za-z_][A-Za-z0-9_-]*) |
    (?P<punct>[{}()\[\];,=:]) |
    (?P<ws>\s+)
""", re.VERBOSE | re.DOTALL)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        mo = _TOKEN.match(text, pos)
        if mo is None:
            raise ValueError(f"config parse error at {text[pos:pos+20]!r}")
        pos = mo.end()
        kind = mo.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, mo.group()
    yield "eof", ""


class _Parser:
    def __init__(self, text: str):
        self.toks = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise ValueError(f"expected {val!r}, got {v!r}")

    def parse_group(self, top=False) -> dict:
        out: dict[str, Any] = {}
        while True:
            k, v = self.peek()
            if k == "eof" or v == "}":
                if not top:
                    self.expect("}")
                else:
                    self.next()
                return out
            if k != "name":
                raise ValueError(f"expected name, got {v!r}")
            self.next()
            nk, nv = self.peek()
            if nv in ("=", ":"):
                self.next()
                out[v] = self.parse_value()
            elif nv == "{":
                self.next()
                out[v] = self.parse_group()
            else:
                raise ValueError(f"expected '=' or '{{' after {v!r}")
            while self.peek()[1] in (";", ","):
                self.next()

    def parse_value(self):
        k, v = self.next()
        if k == "str":
            return v[1:-1].replace('\\"', '"')
        if k == "num":
            if v.startswith("0x"):
                return int(v, 16)
            return float(v) if ("." in v or "e" in v or "E" in v) else int(v)
        if k == "bool":
            return v == "true"
        if v == "{":
            return self.parse_group()
        if v in ("(", "["):
            close = ")" if v == "(" else "]"
            items = []
            while self.peek()[1] != close:
                items.append(self.parse_value())
                while self.peek()[1] == ",":
                    self.next()
            self.next()
            return items
        raise ValueError(f"bad value token {v!r}")


def parse_config(text: str) -> dict:
    return _Parser(text).parse_group(top=True)


def load_config_file(path: str) -> dict:
    with open(path) as f:
        return parse_config(f.read())


# ---------------------------------------------------------------------------
# paramdef tables (config_paramdesc.h analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamDef:
    name: str
    type: type = int
    default: Any = None
    required: bool = False
    help: str = ""


class ConfigModule:
    """Resolved configuration: file dict + CLI overrides + paramdefs."""

    def __init__(self, tree: Optional[dict] = None,
                 cli_overrides: Optional[list[str]] = None):
        self.tree = tree or {}
        self.overrides: dict[str, str] = {}
        for ov in cli_overrides or []:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} must be section.name=value")
            k, v = ov.split("=", 1)
            self.overrides[k.strip("-")] = v

    @classmethod
    def from_cmdline(cls, argv: list[str]) -> "ConfigModule":
        """Parse `-O file[:dbgl<N>]` plus `--sec.name=value` overrides —
        the load_configmodule entry-point shape."""
        tree, overrides = {}, []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-O":
                spec = argv[i + 1]
                i += 1
                path = spec.split(":")[0]
                tree = load_config_file(path)
            elif a.startswith("--") and "=" in a:
                overrides.append(a[2:])
            i += 1
        return cls(tree, overrides)

    def _raw(self, section: str, name: str):
        key = f"{section}.{name}" if section else name
        if key in self.overrides:
            return self.overrides[key], True
        node = self.tree
        for part in (section.split(".") if section else []):
            if not isinstance(node, dict) or part not in node:
                return None, False
            node = node[part]
        if isinstance(node, dict) and name in node:
            return node[name], False
        return None, False

    def get(self, section: str, params: list[ParamDef]) -> dict:
        """Resolve a paramdef table against file + overrides (config_get)."""
        out = {}
        for p in params:
            val, from_cli = self._raw(section, p.name)
            if val is None:
                if p.required:
                    raise KeyError(f"missing required config {section}.{p.name}")
                out[p.name] = p.default
                continue
            if from_cli or not isinstance(val, p.type):
                if p.type is bool and isinstance(val, str):
                    val = val.lower() in ("1", "true", "yes", "on")
                elif p.type is list and isinstance(val, str):
                    val = [type(p.default[0])(x) if p.default else x
                           for x in val.split(",")]
                else:
                    val = p.type(val)
            out[p.name] = val
        return out
