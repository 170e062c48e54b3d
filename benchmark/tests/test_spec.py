"""The harness is driven by data: in a copy of the benchmark, a new
configuration, traffic mix and metric, each a file of its own plus its
entries in BENCHMARK.json, make a cell the harness resolves with no edit
to a file that was there; so does a new program path, and the harness
runs its window.  The names and units of BENCHMARK.json keep to their
characters."""
import json
import re
import shutil
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.spec import ROOT


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_every_cell_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        for m in cell.per_layer:
            assert m["moves"] in [e["name"] for e in cell.end_to_end]
        assert callable(spec.reader(cell.per_layer[0]["name"]))


# a program path of its own: each slot's 4 values scaled by the
# configuration's "scale", checked against the pool it was drawn from
TOY_PATH = '''
import contextlib

import torch


def reference_config(config):
    return config


def program_config(config):
    return config["scale"]


def make_pool(ref, traffic, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = [torch.rand((traffic["slots_per_call"], 4), generator=gen, device=device)
            for _ in range(traffic["pool_calls"])]
    return pool, pool


class steps:
    def __init__(self, cfg, config, sampled):
        self.scale, self.sampled = cfg, set(sampled)
        self.counting, self.n, self.kept = False, 0, {}

    def __call__(self, i, x):
        y = x * self.scale
        if self.counting:
            if self.n in self.sampled:
                self.kept[self.n] = y
            self.n += 1
        return {"y": y}


def verdict(run, steps, pool, truth, sampled, limits):
    wrong = sum(k not in steps.kept
                or not torch.equal(steps.kept[k], truth[k % len(truth)] * run.p["scale"])
                for k in sampled)
    return {"wrong": (wrong, limits["wrong"])}, steps.n * run.slots_per_call, wrong


def layer_spans():
    return contextlib.nullcontext()


def work_of(run, layer):
    return 1.0, "bytes"


def control(cell, seed, device):
    return {"wrong": 0}
'''


@pytest.mark.parametrize("new", ["config", "path"])
def test_a_new_cell_from_added_files_only(copy, new):
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    if new == "config":
        conf = json.loads((copy / "benchmark/configs/nr40-pusch-2l2r-mcs16.json").read_text())
        conf = dict(conf, n_prb=51, mcs=20, n_layers=1)
        name, traffic, cell = "nr40-pusch-1l2r-mcs20", "burst64", "nr40-pusch-1l2r-mcs20.burst64"
        mix = dict(json.loads((copy / "benchmark/traffic/clean32.json").read_text()),
                   slots_per_call=64)
    else:
        (copy / "benchmark/paths/toy.py").write_text(TOY_PATH)
        conf = {"name": "toy-scale3", "path": "toy", "scale": 3.0, "check": {"wrong": 0}}
        name, traffic, cell = "toy-scale3", "toy8", "toy-scale3.toy8"
        mix = {"loop": "closed", "slots_per_call": 8, "pool_calls": 2, "depth": 2}
    (copy / f"benchmark/configs/{name}.json").write_text(json.dumps(conf))
    (copy / f"benchmark/traffic/{traffic}.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/decoded_mbps.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench["configs"].append({"name": name, "source": "a public source",
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "decoded_mbps", "unit": "Mbit/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    got = spec.resolve(cell, copy)
    assert got.config == conf and got.traffic == mix
    assert {m["name"] for m in got.end_to_end} == {"decoded_mbps", "setup_s"}
    assert spec.reader("decoded_mbps", copy)(None) == 1.0
    if new == "path":
        r = harness.run_cell(got, 2**31 + 21, 2.0, False, torch.device("cpu"),
                             time.perf_counter(), copy)
        assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
        assert r["metrics"]["decoded_mbps"]["value"] == 1.0 and "setup_s" in r["metrics"]
        assert r["checks"] == {"wrong": {"value": 0, "limit": 0}}
    changed = [p for p, b in before.items() if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_names_and_units_keep_to_their_characters():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert all(UNIT.fullmatch(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for f in (ROOT / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and ".cache" not in f.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(f.relative_to(ROOT))), f


@pytest.mark.parametrize("breakage", ["no reader", "moves unreported", "no config", "no path"])
def test_resolve_refuses_a_cell_it_cannot_run(copy, breakage):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    if breakage == "no reader":
        (copy / "benchmark/metrics/setup_s.py").unlink()
    elif breakage == "moves unreported":
        bench["per_layer"][0] = dict(bench["per_layer"][0], moves="setup_s.x",
                                     workloads=[cell])
    elif breakage == "no config":
        bench["workloads"][0]["config"] = "no-such-config"
    else:
        (copy / "benchmark/paths/pusch_rx.py").unlink()
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        spec.resolve(cell, copy)
