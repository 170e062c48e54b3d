"""Nothing the harness loads has the top-level name jax, jaxlib, flax or
openairinterface5g_tpu (the JAX package; the port's name begins with it,
so names are compared whole), and the plain reference loads nothing of
the program under test."""
import subprocess
import sys

from benchmark.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "openairinterface5g_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import check, harness, load, nr, spec, tracing, workcount\n"
        "from benchmark.tools import calibrate, sweep\n"
        "from openairinterface5g_tpu_torch.models import pusch\n"
        "from openairinterface5g_tpu_torch.runtime import executor\n"
        "for w in ['nr40-pusch-2l2r-mcs16.clean32', 'nr40-pusch-2l2r-mcs16.open32']:\n"
        "    c = spec.resolve(w)\n"
        "    [spec.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "    harness.program_config(c.config)\n"
        "with tracing.layer_spans():\n"
        "    pass\n")
    assert "openairinterface5g_tpu_torch" in names and "benchmark" in names
    assert not names & FORBIDDEN
    from benchmark import harness
    assert set(harness.JAX_NAMES) == FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import sys; sys.path.insert(0, '.')\n"
                    "from benchmark import check, load, nr, workcount\n")
    assert not names & (FORBIDDEN | {"openairinterface5g_tpu_torch"})


def test_found_jax_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "openairinterface5g_tpu_torch_x", sys)
    assert harness.found_jax() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "openairinterface5g_tpu.models", sys)
    assert "openairinterface5g_tpu" in harness.found_jax()


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "nr40-pusch-2l2r-mcs16.clean32", "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
