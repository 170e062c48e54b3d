"""A cell of BENCHMARK.json resolved to its files by name.

A cell names a configuration and a traffic mix; the configuration's file is
the one its entry gives, the mix's is ``benchmark/traffic/<traffic>.json``,
and each metric's reader is ``benchmark/metrics/<metric>.py``.  A new cell,
mix or metric is a new file and a new entry; no file here changes.  The
rules of the file's format are its checker's, not the harness's: this
module checks only what it needs to run a cell.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    end_to_end: list        # metric entries this cell reports with --trace 0
    per_layer: list         # and with --trace 1


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, checked, with its files
    read; raises ValueError for a name it does not hold or a file missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no cell {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = next((c for c in bench["configs"] if c["name"] == w["config"]), None)
    if conf is None:
        raise ValueError(f"{workload}: no configuration {w['config']!r}")
    traffic = root / "benchmark" / "traffic" / f"{w['traffic']}.json"
    e2e = {m["name"] for m in bench["end_to_end"] if _applies(m, workload)}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not _applies(m, workload):
            continue
        if not reader_path(m["name"], root).exists():
            raise ValueError(f"metric {m['name']}: no reader {reader_path(m['name'], root)}")
        if "moves" in m and m["moves"] not in e2e:
            raise ValueError(f"{workload}: {m['name']} moves {m['moves']!r}, "
                             f"which the cell does not report")
    return Cell(name=workload, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads(traffic.read_text()),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader_path(metric: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{metric}.py"


def reader(metric: str, root: Path = ROOT):
    """The `read(run)` function of the metric's reader file."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
