"""The port's utilities against the JAX package's, on the CPU: the copied
modules (confmod, log, ttrace, itti, telnet, vcd) with the cases of
tests/test_confmod_log_trace.py, tests/test_utils_runtime.py and
tests/test_scope_vcd.py run on the port; the web scope (a tensor published
from any device, the same JSON as JAX's); the profiling module rewritten on
PyTorch (MeasGroup as tests/test_runtime.py:40, its device waits,
profile_to's trace with the trace() spans); the slot executor's default
device.

Sockets bind port 0 and have timeouts; every thread started is joined.
"""
import ast
import json
import logging
import pathlib
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

from openairinterface5g_tpu.utils import log as jlog
from openairinterface5g_tpu.utils import profiling as jprof
from openairinterface5g_tpu.utils.webscope import WebScope as JWebScope
from openairinterface5g_tpu_torch.runtime import executor
from openairinterface5g_tpu_torch.utils import log as log_mod
from openairinterface5g_tpu_torch.utils import profiling
from openairinterface5g_tpu_torch.utils.confmod import ConfigModule, ParamDef, parse_config
from openairinterface5g_tpu_torch.utils.itti import Itti
from openairinterface5g_tpu_torch.utils.telnet import TelnetServer
from openairinterface5g_tpu_torch.utils.ttrace import Tracer
from openairinterface5g_tpu_torch.utils.vcd import VcdDumper
from openairinterface5g_tpu_torch.utils.webscope import WebScope

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIES = ("confmod", "log", "ttrace", "itti", "telnet", "vcd")


def _code(path: pathlib.Path) -> str:
    """The module's AST without its docstring."""
    tree = ast.parse(path.read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_copies_equal_originals(name):
    rel = pathlib.Path("utils") / f"{name}.py"
    assert _code(ROOT / "openairinterface5g_tpu_torch" / rel) == \
        _code(ROOT / "openairinterface5g_tpu" / rel)


# ---- confmod, log, ttrace (tests/test_confmod_log_trace.py) ----

SAMPLE = """
# libconfig-style sample (the gnb.conf shape)
Active_gNBs = ( "gNB-TPU" );
gNBs = {
  gNB_ID = 0xe00;
  ssb_frequency = 3619200000;
  min_rxtxtime = 6;
  servingCellConfigCommon = {
    dl_carrierBandwidth = 273;
    ul_subcarrierSpacing = 1;   // mu
  };
};
log_config = {
  global_log_level = "info";
  phy_log_level = "debug";
};
rfsimulator = {
  serveraddr = "server";
  options = ( "chanmod", "saviq" );
};
"""


def test_parse_libconfig_subset():
    from openairinterface5g_tpu.utils.confmod import parse_config as jparse
    t = parse_config(SAMPLE)
    assert t == jparse(SAMPLE)
    assert t["Active_gNBs"] == ["gNB-TPU"]
    assert t["gNBs"]["gNB_ID"] == 0xE00
    assert t["gNBs"]["ssb_frequency"] == 3619200000
    assert t["gNBs"]["servingCellConfigCommon"]["dl_carrierBandwidth"] == 273
    assert t["rfsimulator"]["options"] == ["chanmod", "saviq"]
    assert t["log_config"]["phy_log_level"] == "debug"


def test_paramdef_resolution_and_cli_override():
    cm = ConfigModule(parse_config(SAMPLE),
                      cli_overrides=["gNBs.min_rxtxtime=2", "gNBs.new_flag=true"])
    vals = cm.get("gNBs", [
        ParamDef("gNB_ID", int, 0),
        ParamDef("min_rxtxtime", int, 5),
        ParamDef("new_flag", bool, False),
        ParamDef("absent_with_default", int, 42),
    ])
    assert vals == {"gNB_ID": 0xE00, "min_rxtxtime": 2, "new_flag": True,
                    "absent_with_default": 42}
    assert vals["new_flag"] is True
    nested = cm.get("gNBs.servingCellConfigCommon", [ParamDef("dl_carrierBandwidth", int, 106)])
    assert nested["dl_carrierBandwidth"] == 273
    with pytest.raises(KeyError):
        cm.get("gNBs", [ParamDef("must_exist", int, required=True)])


def test_log_levels_configured_from_config():
    t = parse_config(SAMPLE)
    log_mod.configure(t["log_config"])
    assert log_mod.get_logger("PHY").level == logging.DEBUG
    assert log_mod.get_logger("MAC").level == logging.INFO
    rows = log_mod.dump_levels()
    assert "PHY    DEBUG" in rows and "MAC    INFO" in rows
    jlog.configure(t["log_config"])          # the same logger names: JAX's resets, then sets
    assert jlog.dump_levels() == rows == log_mod.dump_levels()


def test_tracer_ring_filter_record_replay(tmp_path):
    tr = Tracer(capacity=8)
    tr.T("GNB_PHY_CRC", 1, 2, 0x46, 1)
    iq = np.arange(6, dtype=np.float32).reshape(2, 3)
    tr.T("GNB_PHY_PUSCH_IQ", 1, 2, 0x46, payload=iq)
    assert len(tr.events()) == 2 and len(tr.events("GNB_PHY_CRC")) == 1
    for i in range(20):
        tr.T("GNB_PHY_UL_TIME", 0, i)
    assert len(tr.events()) == 8 and tr.dropped > 0
    tr2 = Tracer()
    tr2.T("GNB_PHY_PUSCH_IQ", 3, 4, 0x99, payload=iq)
    tr2.T("GNB_MAC_SCHED", 3, 4, 0x99, 16, 273)
    p = str(tmp_path / "trace.t5g")
    tr2.save(p)
    evs = list(Tracer.load(p))
    assert [e.name for e in evs] == ["GNB_PHY_PUSCH_IQ", "GNB_MAC_SCHED"]
    np.testing.assert_array_equal(evs[0].payload, iq)
    assert evs[1].fields == (3, 4, 0x99, 16, 273)
    from openairinterface5g_tpu.utils.ttrace import Tracer as JTracer
    jevs = list(JTracer.load(p))                          # the JAX reader reads the port's file
    assert [(e.eid, e.fields) for e in jevs] == [(e.eid, e.fields) for e in evs]


def test_tracer_enable_only():
    tr = Tracer()
    tr.enable_only("GNB_MAC_SCHED")
    tr.T("GNB_PHY_CRC", 0, 0, 1, 1)
    tr.T("GNB_MAC_SCHED", 0, 0, 1, 9, 106)
    assert [e.name for e in tr.events()] == ["GNB_MAC_SCHED"]


# ---- itti, telnet (tests/test_utils_runtime.py) ----

def test_itti_send_and_broadcast():
    bus = Itti()
    seen = {"a": [], "b": []}
    bus.create_task("a", lambda b, m: seen["a"].append((m.msg_id, m.payload)))
    bus.create_task("b", lambda b, m: seen["b"].append((m.msg_id, m.payload)))
    bus.send("a", "CONFIG_REQ", {"x": 1})
    bus.broadcast("TICK", 7)
    assert bus.wait_idle(timeout=5)
    bus.terminate()
    assert ("CONFIG_REQ", {"x": 1}) in seen["a"]
    assert ("TICK", 7) in seen["a"] and ("TICK", 7) in seen["b"]
    assert not any(t.thread.is_alive() for t in bus.tasks.values())


def test_itti_task_to_task():
    bus = Itti()
    out = []
    bus.create_task("relay", lambda b, m: b.send("sink", "FWD", m.payload + 1, origin="relay"))
    bus.create_task("sink", lambda b, m: out.append((m.origin, m.payload)))
    bus.send("relay", "IN", 41)
    assert bus.wait_idle(timeout=5)
    bus.terminate()
    assert out == [("relay", 42)]
    assert not any(t.thread.is_alive() for t in bus.tasks.values())


def _cmd(srv_addr, line: str) -> str:
    with socket.create_connection(srv_addr, timeout=5) as c:
        c.settimeout(5)
        c.sendall((line + "\n").encode())
        return c.makefile().readline().strip()


def test_telnet_get_set_exec():
    srv = TelnetServer().start()
    srv.register_var("snr_db", 10.0)
    srv.register_var("channel", "AWGN")
    srv.register_cmd("sum", lambda *a: sum(map(int, a)))
    try:
        assert _cmd(srv.addr, "get snr_db") == "10.0"
        assert _cmd(srv.addr, "set snr_db 12.5") == "OK"
        assert srv.get("snr_db") == 12.5
        assert _cmd(srv.addr, "set channel TDLA30") == "OK"
        assert srv.get("channel") == "TDLA30"
        assert _cmd(srv.addr, "exec sum 1 2 3") == "6"
        assert "snr_db" in _cmd(srv.addr, "list")
        assert _cmd(srv.addr, "get nope").startswith("ERR")
    finally:
        srv.stop()
    assert not srv.thread.is_alive()


# ---- web scope, VCD (tests/test_scope_vcd.py) ----

def test_webscope_serves_data():
    s = WebScope(port=0)
    try:
        s.publish("const", torch.tensor([1 + 1j, -1 - 1j], dtype=torch.complex64))
        s.publish("llr_hist", torch.arange(16.0))
        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/", timeout=5) as r:
            page = r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/data.json", timeout=5) as r:
            data = r.read().decode()
        assert b"scope" in page
        assert "const" in data and "llr_hist" in data
        assert '"kind": "scatter"' in data and '"kind": "line"' in data
    finally:
        s.close()
    s._thread.join(timeout=5)
    assert not s._thread.is_alive()


def test_webscope_json_equals_jax():
    """The same arrays published to both scopes, the port's as tensors (and
    one numpy array): the same JSON, the downsampling included."""
    rng = np.random.default_rng(0)
    arrays = {
        "const": ((rng.standard_normal(3000) + 1j * rng.standard_normal(3000)) * 0.7
                  ).astype(np.complex64),
        "llr": (rng.standard_normal((4, 700)) * 12.3456789).astype(np.float32),
        "short": np.arange(10.0) / 3,
        "h_abs": np.abs(rng.standard_normal(1024)).astype(np.float32),
    }
    t, j = WebScope(port=0, max_points=256), JWebScope(port=0, max_points=256)
    try:
        for name, a in arrays.items():
            j.publish(name, a)
            t.publish(name, a if name == "short" else torch.from_numpy(a))
        j.publish("forced", arrays["llr"], kind="scatter")
        t.publish("forced", torch.from_numpy(arrays["llr"]), kind="scatter")
        assert t.snapshot_json() == j.snapshot_json()
        assert len(json.loads(t.snapshot_json())["const"]["x"]) == 273   # 3000 points, every 11th
    finally:
        t.close()
        j.close()


def test_vcd_dump(tmp_path):
    v = VcdDumper(str(tmp_path / "trace.vcd"))
    with v.function("rx_func"):
        v.variable("slot", 3)
        with v.function("ldpc_decode"):
            pass
    text = open(v.write()).read()
    assert "$var wire 1" in text and "rx_func" in text
    assert "$var integer 64" in text and "b11 " in text
    assert text.index("rx_func") < text.index("ldpc_decode")


# ---- profiling (rewritten on PyTorch) ----

def test_meas_group_report():
    mg = profiling.MeasGroup()
    for _ in range(3):
        with mg.measure("stage_a"):
            time.sleep(0.001)
    rep = mg.report()
    assert "stage_a" in rep and mg["stage_a"].count == 3
    # the report's format is JAX's
    jm = jprof.MeasGroup()
    for m in (mg, jm):
        m["x"].count, m["x"].total, m["x"].max = 4, 0.0123, 0.005
        m["stage_a"].count, m["stage_a"].total, m["stage_a"].max = 3, 0.0031, 0.0012
    assert mg.report() == jm.report()


def test_meas_stop_waits_for_its_sync():
    """stop(sync) waits on every leaf of a nest that has a synchronize method
    (a torch.cuda.Event or Stream); a CPU tensor has nothing to wait for.
    tests/test_torch_cuda.py holds the CUDA tensor's wait on the card."""
    waited = []

    class Ev:                                  # a torch.cuda.Event's surface
        def __init__(self, tag):
            self.tag = tag

        def synchronize(self):
            waited.append(self.tag)

    m = profiling.Meas("x")
    m.start()
    m.stop(torch.zeros(3))
    m.start()
    m.stop({"a": [Ev(1), torch.zeros(1)], "b": (Ev(2),), "c": 3})
    m.start()
    m.stop(Ev(3))
    assert waited == [1, 2, 3] and m.count == 3 and 0 <= m.mean <= m.max


def test_profile_to_writes_the_spans(tmp_path):
    x = torch.arange(4096.0)
    with profiling.profile_to(str(tmp_path)) as prof:
        with profiling.trace("stage_fft"):
            y = torch.fft.fft(x)
        with profiling.trace("stage_sum"):
            z = (y.abs() ** 2).sum()
    assert float(z) > 0
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"stage_fft", "stage_sum"} <= names
    assert {"stage_fft", "stage_sum"} <= {e.key for e in prof.key_averages()}


# ---- the slot executor's default device ----

def test_executor_default_device_raises_without_cuda(monkeypatch):
    """SlotExecutor() runs on the card unless given the CPU: without CUDA its
    default raises, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        executor.SlotExecutor(lambda i: None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        executor.SlotExecutor(lambda i: None, device="cuda")
    assert executor.SlotExecutor(lambda i: None, device="cpu").device.type == "cpu"
