"""The port's tools (openairinterface5g_tpu_torch/tools) and the launch
probes T1/T2 (ops/tiny.py) on the CPU, at tiny sizes: with ``--device cpu``
they run the plain versions; without CUDA and without it they raise.
"""
import pytest
import torch

from openairinterface5g_tpu_torch.ops import ldpc_decoder, tiny
from openairinterface5g_tpu_torch.tools import bench_ldpc_kernel, bench_overhead

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TINY = ["--device", "cpu", "--bg", "2", "--Z", "64", "--cbs", "2", "--reps", "2"]


@pytest.mark.parametrize("check_every", ["0", "1"])
def test_bench_ldpc_kernel_cpu(check_every, capsys):
    out = bench_ldpc_kernel.main(TINY + ["--variants", "f32,bf16:sb32,int8",
                                         "--check-every", check_every])
    assert [r["variant"] for r in out] == ["f32", "bf16:sb32", "int8"]
    for r in out:
        assert r["ok"] == 2 and r["bits_equal_sent"] and r["ms"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert "cpu, plain versions, host clock" in lines[0]
    assert lines[1].split()[2] == "ms/2cb" and lines[1].endswith("ok=2/2")


def test_bench_ldpc_kernel_variant_parts():
    assert bench_ldpc_kernel.parse_variant("int8:sb8") == torch.int8
    with pytest.raises(ValueError, match="not carried"):
        bench_ldpc_kernel.parse_variant("f32:noroll")
    with pytest.raises(ValueError):
        bench_ldpc_kernel.parse_variant("f16")


def test_tools_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_ldpc_kernel.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_overhead.main([])


def test_bench_overhead_cpu(monkeypatch):
    # two steps per probe instead of eight: the plain K1 decode at BG1 Z=384
    # sets this test's time on the CPU
    monkeypatch.setattr(bench_overhead, "R", 2)
    n0 = dict(ldpc_decoder.launches), dict(tiny.launches)
    out = bench_overhead.run("cpu", cbs=1)
    assert [r["probe"][0] for r in out] == ["a", "b", "d", "e", "c"]
    assert all(r["host_ms"] > 0 and r["device_ms"] is None for r in out)
    assert (dict(ldpc_decoder.launches), dict(tiny.launches)) == n0   # plain versions only


@pytest.mark.parametrize("fn,shape", [(tiny.tiny, (8, 128)), (tiny.tiny_grid, (8, 8, 128))])
def test_tiny_plain(fn, shape):
    x = torch.randn(shape)
    n0 = dict(tiny.launches)
    assert torch.equal(fn(x), x * 2)
    assert torch.equal(tiny.tiny_plain(x), x * 2)
    assert tiny.launches == n0


def test_bench_ldpc_layered_needs_cuda(monkeypatch):
    from openairinterface5g_tpu_torch.tools import bench_ldpc_layered
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        bench_ldpc_layered.run()


def test_bench_frontend_needs_cuda(monkeypatch):
    from openairinterface5g_tpu_torch.tools import bench_frontend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        bench_frontend.run()


def test_bench_frontend_kernel_rows():
    """The profiler keys of either checkout: one kernel (this one) or two
    (estimate, equalize); every kernel that ran must have run each call."""
    from openairinterface5g_tpu_torch.tools import bench_frontend as bf
    one = {"frontend_kernel": (200.0, 20), "estimate_kernel": (0.0, 0),
           "equalize_llr_kernel": (0.0, 0)}
    assert bf.kernel_rows(one, 20) == {"frontend_kernel": 0.01}
    two = {"frontend_kernel": (0.0, 0), "estimate_kernel": (300.0, 20),
           "equalize_llr_kernel": (500.0, 20)}
    rows = bf.kernel_rows(two, 20)
    assert rows == pytest.approx({"estimate_kernel": 0.015, "equalize_llr_kernel": 0.025})
    s = bf.summary(rows, events=0.05, graph=0.046)
    assert s["device_ms"] == pytest.approx(0.04) and s["gaps_ms"] == pytest.approx(0.006)
    for found in ({k: (0.0, 0) for k in bf.KEYS},
                  {**two, "equalize_llr_kernel": (480.0, 19)}):
        with pytest.raises(AssertionError, match="profiler"):
            bf.kernel_rows(found, 20)


def test_bench_frontend_rel_err_and_cases():
    from openairinterface5g_tpu_torch.models import pusch
    from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
    from openairinterface5g_tpu_torch.tools import bench_frontend as bf
    ref = torch.tensor([[1.0, -4.0], [2.0, 0.5]])
    assert bf.rel_err(ref + 1e-3, ref) == pytest.approx(2.5e-4, rel=1e-4)
    with pytest.raises(AssertionError):
        bf.rel_err(ref.flatten(), ref)
    with pytest.raises(AssertionError):
        bf.rel_err(ref * float("nan"), ref)
    # every card case is a configuration the kernel takes, B = 1 and 40 included
    from openairinterface5g_tpu_torch.ops.pusch_frontend_cases import CARD_CASES
    assert {B for _, B in CARD_CASES} >= {1, 40}
    for kw, _ in CARD_CASES:
        assert fe.supported(pusch.PuschConfig(mu=1, **kw)), kw


def test_bench_frontend_alternates():
    from openairinterface5g_tpu_torch.tools import bench_frontend as bf
    seen = []
    fn = bf.alternate(lambda: seen.append("a"), lambda: seen.append("b"))
    for _ in range(5):
        fn()
    assert seen == ["a", "b", "a", "b", "a"]
