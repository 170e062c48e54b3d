"""The port's tools (openairinterface5g_tpu_torch/tools) and the launch
probes T1/T2 (ops/tiny.py) on the CPU, at tiny sizes: with ``--device cpu``
they run the plain versions; without CUDA and without it they raise.
"""
import pytest
import torch

from openairinterface5g_tpu_torch.ops import ldpc_decoder, tiny
from openairinterface5g_tpu_torch.tools import bench_ldpc_kernel, bench_overhead

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


def test_bench_overhead_cpu():
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
