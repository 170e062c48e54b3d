"""The port's kernel launch route (ops/_cuda.py, csrc/launch.cuh) on the CPU.

No kernel runs here.  These tests hold the parts of the route that need no
card:
  * every C entry point in csrc/*.cu against its ctypes signature in
    ``_cuda._SIGNATURES`` (the count and kind of each parameter): a
    mismatch is silent under ctypes;
  * each wrapper's argument check, given only shapes, types and flags;
  * each wrapper's launch path, driven with meta tensors into a stand-in
    route whose entry points convert their arguments as the library's
    ctypes functions do, with ``torch.cuda.device`` and
    ``torch.cuda.current_stream`` made to raise.
"""
import ctypes
import re
import shutil
import types

import pytest
import torch

from openairinterface5g_tpu_torch.coding import ldpc
from openairinterface5g_tpu_torch.models import pusch
from openairinterface5g_tpu_torch.ops import _cuda, ldpc_decoder, tiny
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
_MAIN_PATH = dict(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2)   # chip_smoke.py's


def _kind(param: str) -> str:
    """The ctypes kind of one C parameter declaration."""
    param = " ".join(param.split())
    if "*" in param:
        return "pointer"
    return {"int": "int", "float": "float"}.get(param.split()[0], f"unknown: {param}")


def _entry_points() -> dict:
    """name -> parameter kinds of every extern "C" function in csrc/*.cu."""
    found = {}
    for src in _cuda.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [_kind(p) for p in params.split(",")]
    return found


def test_every_entry_point_has_a_signature():
    assert sorted(_entry_points()) == sorted(_cuda._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_signature_matches_source(name):
    kinds = [_KINDS[t] for t in _cuda._SIGNATURES[name]]
    assert kinds == _entry_points()[name]
    assert kinds[-2:] == ["int", "pointer"]          # every entry ends (device, stream)


@pytest.mark.parametrize("src", [p.name for p in _cuda.sources()])
def test_sources_take_the_route(src):
    """Each source includes the route's header, guards the device in every
    entry point and sets no kernel attribute itself (SmemLimit does, once)."""
    text = (_cuda.CSRC / src).read_text()
    assert '#include "launch.cuh"' in text
    assert text.count("DeviceGuard guard(device)") == text.count('extern "C"')
    assert "cudaFuncSetAttribute" not in text


def test_digest_covers_the_header(tmp_path, monkeypatch):
    shutil.copytree(_cuda.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path / "csrc")
    before = _cuda._digest()
    with open(tmp_path / "csrc" / "launch.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _cuda._digest() != before


# --------------------------------------------------------------------------
# argument checks, from shapes, types and flags alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape,dtype,contiguous,ok", [
    ("tiny", (8, 128), torch.float32, True, True),
    ("tiny_grid", (8, 8, 128), torch.float32, True, True),
    ("tiny", (4, 128), torch.float32, True, False),
    ("tiny_grid", (8, 128), torch.float32, True, False),
    ("tiny", (8, 128), torch.float64, True, False),
    ("tiny", (8, 128), torch.float32, False, False),
])
def test_tiny_check(name, shape, dtype, contiguous, ok):
    if ok:
        tiny.check_args(name, torch.Size(shape), dtype, contiguous)
    else:
        with pytest.raises(ValueError, match=name):
            tiny.check_args(name, torch.Size(shape), dtype, contiguous)


_BG1 = ldpc.build_graph(1, 384)


@pytest.mark.parametrize("shape,contiguous,n_iters,check_every,ok", [
    ((208, 68 * 384), True, 8, 1, True),             # the main path's 208 code blocks
    ((1, 68 * 384), True, 0, 0, True),
    ((208, 10), True, 8, 1, False),
    ((208, 68 * 384, 1), True, 8, 1, False),
    ((208, 68 * 384), False, 8, 1, False),
    ((208, 68 * 384), True, -1, 1, False),
    ((208, 68 * 384), True, 8, -1, False),
])
def test_decode_check(shape, contiguous, n_iters, check_every, ok):
    args = (_BG1, torch.Size(shape), contiguous, n_iters, check_every)
    if ok:
        ldpc_decoder.check_args(*args)
    else:
        with pytest.raises(ValueError, match="decode"):
            ldpc_decoder.check_args(*args)


def test_decode_check_refuses_z_above_384():
    wide = types.SimpleNamespace(cols=52, Z=416)
    with pytest.raises(ValueError, match="384"):
        ldpc_decoder.check_args(wide, torch.Size((2, 52 * 416)), True, 8, 0)


@pytest.mark.parametrize("shape,dtype,contiguous,ok", [
    ((8, 2, 14, 3276), torch.complex64, True, True),    # the main path's grid
    ((1, 2, 14, 3276), torch.complex64, True, True),
    ((8, 1, 14, 3276), torch.complex64, True, False),
    ((8, 2, 14, 3264), torch.complex64, True, False),
    ((2, 14, 3276), torch.complex64, True, False),
    ((8, 2, 14, 3276), torch.complex128, True, False),
    ((8, 2, 14, 3276), torch.complex64, False, False),
])
def test_frontend_check(shape, dtype, contiguous, ok):
    cfg = pusch.PuschConfig(**_MAIN_PATH)
    grid = (cfg.n_rx, cfg.fp.symbols_per_slot, cfg.fp.n_sc)
    if ok:
        fe.check_args(grid, torch.Size(shape), dtype, contiguous)
    else:
        with pytest.raises(ValueError, match="frontend_planes"):
            fe.check_args(grid, torch.Size(shape), dtype, contiguous)


# --------------------------------------------------------------------------
# the launch paths, into a stand-in route
# --------------------------------------------------------------------------

class _Route:
    """Stands in for ``_cuda.route()``.  Each entry point is a ctypes
    function of the real signature around a recorder, so a call converts
    its arguments as the library's functions do: a wrong count or type
    raises.  ``stream`` returns a fixed handle; ``pusch_frontend_clusters``
    reports ACTIVE clusters."""
    STREAM = 0x5EED
    ACTIVE = 4

    def __init__(self, rc: int = 0):
        self.calls = []
        for name, argtypes in _cuda._SIGNATURES.items():
            def record(*args, name=name):
                self.calls.append((name, args))
                if name == "pusch_frontend_clusters" and not rc:
                    ctypes.c_int.from_address(args[4]).value = self.ACTIVE
                return rc
            setattr(self, name, ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(record))

    def stream(self, index: int) -> int:
        return self.STREAM


def _forbidden(*args, **kwargs):
    raise AssertionError("called on a launch path")


@pytest.fixture
def route(monkeypatch):
    fake = _Route()
    monkeypatch.setattr(_cuda, "_ROUTE", fake)
    monkeypatch.setattr(torch.cuda, "device", _forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", _forbidden)
    monkeypatch.setattr(tiny, "launches", dict(tiny.launches))
    monkeypatch.setattr(ldpc_decoder, "launches", dict(ldpc_decoder.launches))
    monkeypatch.setattr(fe, "launches", fe.launches)
    fe._plan.cache_clear()                   # plans made under another route
    yield fake
    fe._plan.cache_clear()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name,shape,n_blocks", [("tiny", (8, 128), 1),
                                                 ("tiny_grid", (8, 8, 128), 8)])
def test_tiny_launch_path(route, name, shape, n_blocks):
    n0 = tiny.launches[name]
    out = tiny._launch(name, _meta(shape))
    assert out.shape == shape and out.dtype == torch.float32
    # meta tensors have null data pointers and device index -1
    assert route.calls == [("tiny_times_two", (None, None, n_blocks, -1, _Route.STREAM))]
    assert tiny.launches[name] == n0 + 1


@pytest.mark.parametrize("schedule,msg_dtype,in_dtype,entry,codes", [
    ("layered", torch.float32, torch.float32, "ldpc_layered_decode", (0, 0)),
    ("layered", torch.float32, torch.bfloat16, "ldpc_layered_decode", (1, 0)),
    ("flooding", torch.float32, torch.float32, "ldpc_flooding_decode", (0, 0)),
    ("layered", torch.int8, torch.float32, "ldpc_layered_decode", (2, 1)),
    ("flooding", torch.int8, torch.float32, "ldpc_flooding_decode", (2, 1)),
    ("flooding", torch.bfloat16, torch.float32, "ldpc_flooding_decode", (1, 2)),
    ("layered", torch.bfloat16, torch.float32, "ldpc_layered_decode", (1, 3)),   # K2
])
@pytest.mark.parametrize("return_iters", [False, True])
def test_decode_launch_path(route, monkeypatch, schedule, msg_dtype, in_dtype, entry, codes,
                            return_iters):
    """Both schedules and K2 take one C signature: the input and message
    kinds (K2 is message kind 3), the outputs, the state scratch (3 words
    per row and lane for f32 and int8 messages, 2 for bf16), the graph
    table of 28 layers of BG2's 42 rows."""
    g = ldpc.build_graph(2, 64)
    name = ldpc_decoder.kernel_name(schedule, msg_dtype)
    E = int(g.evalid.sum())
    n0 = ldpc_decoder.launches[name]
    x = _meta((3, g.cols * g.Z), in_dtype)
    allocated = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        allocated.append(real_empty(*args, **kwargs))
        return allocated[-1]

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", empty)
        out = ldpc_decoder._launch(name, g, x, 6, 0.8, msg_dtype, 1, return_iters)
    bits, ok = out[:2]
    assert len(out) == (3 if return_iters else 2)
    assert bits.shape == (3, g.K) and bits.dtype == torch.int8
    assert ok.shape == (3,) and ok.dtype == torch.bool
    [(called, args)] = route.calls
    assert called == entry and args[-2:] == (-1, _Route.STREAM)
    assert args[1:3] == codes
    if return_iters:        # (a meta tensor's data pointer is null too)
        assert out[2].shape == (3,) and out[2].dtype == torch.int32
    else:
        assert args[5] is None                           # no iterations asked: null
    # one state scratch, and no (B, E, Z) messages
    words = 2 if msg_dtype == torch.bfloat16 else 3
    state = [t for t in allocated if t.dtype == torch.int32 and t.dim() == 1 and t.numel() > 3]
    assert [t.numel() for t in state] == [words * 3 * g.rows * g.Z]
    assert max(t.numel() for t in allocated) < 3 * E * g.Z      # nothing of (B, E, Z)
    assert args[8:17] == (3, 28, g.rows, g.cols, E, g.Z, g.K, 6, 1)
    alpha = 0.80078125 if msg_dtype == torch.bfloat16 else 0.8   # bf16 paths: alpha in bf16
    assert args[17] == pytest.approx(alpha, rel=1e-7)
    assert ldpc_decoder.launches[name] == n0 + 1


def test_frontend_launch_path(route):
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2)
    n0 = fe.launches
    for _ in range(2):
        planes = fe._launch(cfg, _meta((3, 2, 14, 288), torch.complex64))
    qm = cfg.qm_rate[0]
    assert planes.shape == (3, qm, cfg.G // qm) and planes.dtype == torch.float32
    # the plan asks the card once, for the planned cluster size, then two launches
    shape = fe.shape_of(8, 2, 2, 144, 1, 13, 8)
    assert [c for c, _ in route.calls] == ["pusch_frontend_clusters"] + ["pusch_frontend"] * 2
    assert route.calls[0][1][:4] == (2, qm, 8, shape.smem)
    assert route.calls[0][1][5:] == (-1, None)
    args = route.calls[1][1]
    # DMRS on symbol 2, data on the other 13 of 0-13; then the shape
    assert args[4:] == (3, 2, 2, 14, 288, 0, 24, 0, 1, 13, qm, 8, 1 << 2, 0x3FFF & ~(1 << 2),
                        *shape, -1, _Route.STREAM)
    assert shape.C == 8 and shape.r_grp == 2 and shape.s_buf == 13
    assert fe.launches == n0 + 2


def test_frontend_plan_falls_back_to_a_smaller_cluster(route):
    """Where the card holds no cluster of the planned size, the plan takes
    the next smaller size that it holds; where it holds none, the launch
    raises."""
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2)
    route.ACTIVE = 0
    with pytest.raises(ValueError, match="no cluster"):
        fe._launch(cfg, _meta((3, 2, 14, 288), torch.complex64))
    assert [a[2] for c, a in route.calls] == [8, 4, 2, 1]
    sizes = iter([0, 3])
    fake = _Route()
    for name, argtypes in _cuda._SIGNATURES.items():
        if name == "pusch_frontend_clusters":
            def answer(*args):
                fake.calls.append(("pusch_frontend_clusters", args))
                ctypes.c_int.from_address(args[4]).value = next(sizes)
                return 0
            fake.pusch_frontend_clusters = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(answer)
    _cuda._ROUTE = fake
    fe._plan.cache_clear()
    fe._launch(cfg, _meta((3, 2, 14, 288), torch.complex64))
    assert [a[2] for c, a in fake.calls if c == "pusch_frontend_clusters"] == [8, 4]
    assert fake.calls[-1][0] == "pusch_frontend" and fake.calls[-1][1][18] == 4


def test_frontend_launch_refuses_unsupported_config(route):
    """Every launch with an unsupported configuration raises (the plan cache
    keeps no failure), and nothing is launched."""
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2, chest_window=0,
                            dmrs_max_len=2)
    n0 = fe.launches
    for _ in range(2):
        with pytest.raises(ValueError, match="not supported"):
            fe._launch(cfg, _meta((3, 2, 14, 288), torch.complex64))
    assert route.calls == [] and fe.launches == n0


def test_launch_failure_raises(monkeypatch, route):
    monkeypatch.setattr(_cuda, "_ROUTE", _Route(rc=700))
    n0 = tiny.launches["tiny"]
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        tiny._launch("tiny", _meta((8, 128)))
    assert tiny.launches["tiny"] == n0


def test_wrappers_refuse_other_devices():
    g = ldpc.build_graph(2, 64)
    cfg = pusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2)
    with pytest.raises(ValueError, match="not CUDA or CPU"):
        tiny.tiny(_meta((8, 128)))
    with pytest.raises(ValueError, match="not CUDA or CPU"):
        ldpc_decoder.decode(g, _meta((3, g.cols * g.Z)))
    with pytest.raises(ValueError, match="not CUDA or CPU"):
        fe.frontend_planes(cfg, _meta((3, 2, 14, 288), torch.complex64))


@pytest.mark.parametrize("module", ["_cuda", "tiny", "ldpc_decoder", "pusch_frontend"])
def test_no_torch_device_or_stream_objects_in_the_route(module):
    text = (_cuda.CSRC.parent / "ops" / f"{module}.py").read_text()
    assert "torch.cuda.device(" not in text and "current_stream(" not in text


def test_bench_launch_ratios_pair_each_window():
    from openairinterface5g_tpu_torch.tools import bench_launch
    samples = {name: {"host_us": [2.0, 30.0, 4.0], "ms": [1.0, 1.0, 1.0]}
               for name in ("tiny", "tiny_grid")}
    for lib in bench_launch.PAIRS.values():
        samples[lib] = {"host_us": [4.0, 10.0, 2.0], "ms": [2.0, 2.0, 2.0]}
    r = bench_launch.ratios(samples)
    # per window 0.5, 3 and 2: the median is 2, where the medians' ratio is 1
    assert r["tiny"] == {"host_us": 2.0, "ms": 0.5} == r["tiny_grid"]
    assert bench_launch.summary(samples)["tiny"]["host_us"] == {"median": 4.0, "min": 2.0,
                                                                "max": 30.0}


def test_bench_launch_host_costs_in_torch_mul_calls():
    from openairinterface5g_tpu_torch.tools import bench_launch
    samples = {"batch_ms": [9.0, 9.0, 9.0], "enqueue_us": [80.0, 300.0, 90.0],
               "pusch_frontend_us": [30.0, 60.0, 40.0], "torch_mul_us": [10.0, 20.0, 10.0]}
    # per window 8, 15, 9 and 3, 3, 4; batch_ms is no host cost
    assert bench_launch.in_torch_mul_calls(samples) == {"enqueue_us": 9.0,
                                                         "pusch_frontend_us": 3.0}


def test_bench_launch_needs_cuda(monkeypatch):
    from openairinterface5g_tpu_torch.tools import bench_launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        bench_launch.main([])
