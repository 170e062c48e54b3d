"""The reduction of a Chrome trace to device time and operations per
layer, busy time, top operations and idle gaps, on a hand-made trace."""
import pytest

from benchmark import tracing


def X(name, cat, ts, dur, corr=None):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X(tracing.WINDOW, "user_annotation", 0, 1000),
    X("models/pusch.py", "user_annotation", 10, 500),
    X("phy/ofdm.py", "user_annotation", 20, 30),
    X("coding/decode", "user_annotation", 100, 50),
    X("cudaLaunchKernel", "cuda_runtime", 25, 2, corr=1),
    X("cudaLaunchKernel", "cuda_runtime", 110, 2, corr=2),
    X("cudaLaunchKernel", "cuda_runtime", 300, 2, corr=3),
    X("cudaMemcpyAsync", "cuda_runtime", 700, 2, corr=4),
    X("fft", "kernel", 40, 100, corr=1),           # ofdm
    X("ldpc", "kernel", 120, 200, corr=2),         # decode, overlaps the fft's end
    X("cat", "kernel", 400, 50, corr=3),           # pusch_rx outside sub-spans
    X("Memcpy DtoH", "gpu_memcpy", 800, 100, corr=4),   # launched outside every span
]


def test_reduce_attributes_and_merges():
    r = tracing.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((320 - 40 + 50 + 100) * 1e-6)
    assert r["layer_s"] == pytest.approx({"phy/ofdm.py": 100e-6, "coding/decode": 200e-6,
                                          "models/pusch.py": 50e-6,
                                          tracing.OUTSIDE: 100e-6})
    assert r["layer_ops"] == {"phy/ofdm.py": 1, "coding/decode": 1, "models/pusch.py": 1,
                              tracing.OUTSIDE: 1}
    assert r["device_ops"][0] == ["ldpc", pytest.approx(200e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["models/pusch.py: cat"] == pytest.approx(80e-6)
    assert gaps[tracing.OUTSIDE + ": Memcpy DtoH"] == pytest.approx(350e-6)
    assert gaps["before the first operation"] == pytest.approx(40e-6)
    assert gaps["end"] == pytest.approx(100e-6)


def test_reduce_without_the_window_is_empty():
    assert tracing.reduce(EVENTS[1:]) == {}
