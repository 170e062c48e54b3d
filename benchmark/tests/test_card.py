"""On the card (skipped without one): one short run of a cell of each
program path through benchmark/run.py, its last line in the contract's
form and correct, and each path's control, at a batch a test run holds,
failing the check."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark.spec import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["nr40-pusch-2l2r-mcs16.clean32", "nr100-pdsch-1l-mcs9.tx32"])
def test_a_short_run_is_correct(card, name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"slots_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.parametrize("name, number", [("nr40-pusch-2l2r-mcs16.clean32", "llr_gap"),
                                          ("nr100-pdsch-1l-mcs9.tx32", "wave_gap")])
def test_control_fails_the_check(card, name, number):
    from benchmark import spec
    from benchmark.tools import calibrate
    cell = spec.resolve(name)
    cell.traffic = dict(cell.traffic, slots_per_call=4, pool_calls=2)
    got = calibrate.control(cell, 2**31 + 7, card)
    assert got[number] > cell.config["check"][number]
