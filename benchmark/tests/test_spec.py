"""The harness is driven by data: in a copy of the benchmark, a new
configuration, traffic mix and metric, each a file of its own plus its
entries in BENCHMARK.json, make a cell the harness resolves with no edit
to a file that was there.  The names and units of BENCHMARK.json keep to
their characters."""
import json
import re
import shutil

import pytest

from benchmark import spec
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


def test_a_new_cell_from_added_files_only(copy):
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    conf = json.loads((copy / "benchmark/configs/nr40-pusch-2l2r-mcs16.json").read_text())
    (copy / "benchmark/configs/nr40-pusch-1l2r-mcs20.json").write_text(
        json.dumps(dict(conf, n_prb=51, mcs=20, n_layers=1)))
    (copy / "benchmark/traffic/burst64.json").write_text(json.dumps(
        dict(json.loads((copy / "benchmark/traffic/clean32.json").read_text()),
             slots_per_call=64)))
    (copy / "benchmark/metrics/decoded_mbps.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench["configs"].append({"name": "nr40-pusch-1l2r-mcs20", "source": "a public source",
                             "file": "benchmark/configs/nr40-pusch-1l2r-mcs20.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "nr40-pusch-1l2r-mcs20.burst64",
                               "config": "nr40-pusch-1l2r-mcs20", "traffic": "burst64",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "decoded_mbps", "unit": "Mbit/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["nr40-pusch-1l2r-mcs20.burst64"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("nr40-pusch-1l2r-mcs20.burst64", copy)
    assert cell.config["n_prb"] == 51 and cell.traffic["slots_per_call"] == 64
    assert {m["name"] for m in cell.end_to_end} == {"decoded_mbps", "setup_s"}
    assert spec.reader("decoded_mbps", copy)(None) == 1.0
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


@pytest.mark.parametrize("breakage", ["no reader", "moves unreported", "no config"])
def test_resolve_refuses_a_cell_it_cannot_run(copy, breakage):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    if breakage == "no reader":
        (copy / "benchmark/metrics/setup_s.py").unlink()
    elif breakage == "moves unreported":
        bench["per_layer"][0] = dict(bench["per_layer"][0], moves="setup_s.x",
                                     workloads=[cell])
    else:
        bench["workloads"][0]["config"] = "no-such-config"
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        spec.resolve(cell, copy)
