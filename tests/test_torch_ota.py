"""The port's over-the-air loops on the CPU: the rfsim hub it builds, RA and
connected mode over the hub, the UE softmodem and the IF4p5 RU/L1 split;
cases after tests/test_rfsim.py, test_ra_ota.py, test_connected_ota.py,
test_ue_softmodem.py and test_ru_l1_split.py.

The hub's AWGN comes from its own seeded generator (native/rfsim/rfsim.cpp),
so a run through the port's build of the same source sees the noise the JAX
runs saw: the RA and connected-mode lines are held to the JAX package's
recorded runs (RA_OTA_r4.txt, CONNECTED_OTA_r5.txt,
CONNECTED_OTA_L2_r5.txt).  JAX's loops are not run again here (the JAX
tests run them), except the UE softmodem at one slot, whose inputs are
numpy draws: its [sync] and [mib] lines and verdict must equal JAX's.
Each test binds ports of its own (48xxx), none a JAX test binds.
"""
import contextlib
import hashlib
import io
import pathlib
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.fronthaul import if4p5 as jif4p5
from openairinterface5g_tpu.models import pbch as jpbch
from openairinterface5g_tpu.models import pdcch as jpdcch
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.models import sync as jsync
from openairinterface5g_tpu.radio import rfsim as jrfsim
from openairinterface5g_tpu.runtime import ue_softmodem as jue_softmodem
from openairinterface5g_tpu_torch.fronthaul import if4p5
from openairinterface5g_tpu_torch.radio import iqplayer, rfsim
from openairinterface5g_tpu_torch.runtime import connected_ota, ra_ota, ru_l1_split, ue_softmodem
from openairinterface5g_tpu_torch.tools import ota_records

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKED_IN_HUB = ROOT / "native" / "rfsim" / "librfsim.so"


def _record_lines(name: str, prefix: str) -> list[str]:
    return [line for line in (ROOT / name).read_text().splitlines() if line.startswith(prefix)]


# ---- the hub ----

def _loopback(mod, port: int) -> np.ndarray:
    """Three frames from a client through a listener's 2-tap channel with
    AWGN of sigma 0.1 (the FIR's state carries across the frames)."""
    got, ready = {}, threading.Event()

    def server():
        d = mod.RfSimDevice.listen(port, n_ant=1)
        d.set_channel(np.array([1.0, 0.12 + 0.05j], np.complex64), noise_sigma=0.1)
        ready.set()
        got["rx"] = d.read(0, 700)
        d.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    c = mod.RfSimDevice.connect("127.0.0.1", port, n_ant=1)
    assert ready.wait(timeout=10)
    x = (np.random.default_rng(4).standard_normal((700, 2)) @ np.array([1, 1j])
         ).astype(np.complex64)
    c.write(0, x[:200])
    c.write(200, x[200:450])
    c.write(450, x[450:])
    t.join(timeout=10)
    c.close()
    assert not t.is_alive()
    return got["rx"]


def test_hub_gives_the_jax_bindings_samples():
    """The port's build of rfsim.cpp and the JAX binding's library give the
    same received samples, channel and noise included."""
    before = (CHECKED_IN_HUB.stat().st_mtime_ns, hashlib.sha256(CHECKED_IN_HUB.read_bytes()).digest())
    got = _loopback(rfsim, 48701)
    want = _loopback(jrfsim, 48702)
    np.testing.assert_array_equal(got, want)
    assert float(np.std(got - _loopback(rfsim, 48703))) == 0.0   # each link reseeds
    lib = pathlib.Path(rfsim._load()._name)
    assert lib.parent == ROOT / "openairinterface5g_tpu_torch" / "_build"
    assert (CHECKED_IN_HUB.stat().st_mtime_ns,
            hashlib.sha256(CHECKED_IN_HUB.read_bytes()).digest()) == before


def test_hub_record_replay_match_jax(tmp_path):
    iq = (np.random.default_rng(1).standard_normal((777, 2)) @ np.array([1, 1j])
          ).astype(np.complex64)
    rfsim.record_iq(str(tmp_path / "t.iq"), iq)
    jrfsim.record_iq(str(tmp_path / "j.iq"), iq)
    assert (tmp_path / "t.iq").read_bytes() == (tmp_path / "j.iq").read_bytes()
    np.testing.assert_array_equal(rfsim.replay_iq(str(tmp_path / "j.iq"), 777), iq)
    np.testing.assert_array_equal(jrfsim.replay_iq(str(tmp_path / "t.iq"), 777), iq)
    dev = iqplayer.IQPlayerDevice(str(tmp_path / "t.iq"), n_ant=1, mode="replay")
    np.testing.assert_array_equal(dev.read(770, 14)[0], np.concatenate([iq[770:], iq[:7]]))


def test_hub_build_failure_raises(tmp_path, monkeypatch):
    """A hub that does not compile raises; nothing falls back to the
    checked-in library."""
    bad = tmp_path / "rfsim.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rfsim, "SOURCE", bad)
    monkeypatch.setattr(rfsim, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rfsim, "_lib", None)
    with pytest.raises(RuntimeError, match="building the rfsim hub failed"):
        rfsim.RfSimDevice.listen(48704)


# ---- RA and connected mode over the air ----

def _endpoints(gnb, ue):
    """gNB in a thread, UE in this one (tests/test_ra_ota.py): both results."""
    res = {}
    t = threading.Thread(target=lambda: res.__setitem__("gnb", gnb()), daemon=True)
    t.start()
    res["ue"] = ue()
    t.join(timeout=300)
    assert not t.is_alive()
    return res


def test_ra_over_the_air_gives_the_recorded_lines():
    lines = []
    res = _endpoints(lambda: ra_ota.run_gnb(48711, log=lines.append, device="cpu"),
                     lambda: ra_ota.run_ue(48711, log=lines.append, device="cpu"))
    assert res == {"gnb": True, "ue": True}
    for role in ("[gnb]", "[ue]"):
        assert [line for line in lines if line.startswith(role)] == \
            _record_lines("RA_OTA_r4.txt", role)


@pytest.mark.parametrize("l2", [False, True], ids=["plain", "l2"])
def test_connected_cycles_give_the_recorded_lines(l2):
    """Two cycles: the DL ACK, the UL OK, every UL packet intact, and each
    [gnb] cycle line that of the JAX run's record."""
    port = 48722 if l2 else 48721
    lines = []
    res = _endpoints(
        lambda: connected_ota.run_gnb(port, n_cycles=2, log=lines.append, l2_stack=l2,
                                      device="cpu"),
        lambda: connected_ota.run_ue(port, n_cycles=2, log=lambda *a: None, l2_stack=l2,
                                     device="cpu"))
    st = res["gnb"]
    assert st["slots"] == 8 and st["dl_ack"] > 0 and st["dl_mbps"] > 0, st
    assert st["ul_ok"] > 0 and st["ul_mbps"] > 0, st
    if l2:
        assert st["ul_pkts"] > 0 and st["ul_pkts_intact"] == st["ul_pkts"], st
        assert res["ue"].get("dl_pkts", 0) > 0, res["ue"]
    got = [line for line in lines if line.startswith("[gnb] cyc")]
    record = "CONNECTED_OTA_L2_r5.txt" if l2 else "CONNECTED_OTA_r5.txt"
    assert got == _record_lines(record, "[gnb] cyc")[: len(got)] and len(got) == 3


def test_ra_as_two_processes(tmp_path):
    """tools/ota_records.py's session, as chip_smoke.py phase 12 and the
    records run it: the gNB and the UE as two OS processes through their
    CLIs; the record it writes differs from RA_OTA_r4.txt in no line."""
    res = ota_records.session("ra", 48741, device="cpu", timeout_s=180)
    assert res["gnb"]["result"] is True and res["ue"]["result"] is True
    assert res["gnb"]["launches"] == res["ue"]["launches"] == \
        {"pusch_frontend": 0, "layered_f32": 0}         # plain versions on the CPU
    diffs = ota_records.write_record(tmp_path / "RA.txt", "ra", "ra", res, "RA on the CPU", 0,
                                     "cpu")
    assert diffs == []
    text = (tmp_path / "RA.txt").read_text()
    assert "[gnb] 0 lines differ, [ue] 0 lines differ" in text
    assert "RA over-the-air OK" in text and "UE RA OK" in text


# ---- the UE softmodem ----

def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _opt0(fn):
    """fn with its array arguments compiled as one program at XLA's
    optimization level 0 (its other arguments held static)."""
    def call(*args, **kw):
        pos = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

        def on_arrays(*xs):
            full = list(args)
            for i, x in zip(pos, xs):
                full[i] = x
            return fn(*full, **kw)
        return _compiled(on_arrays, *[args[i] for i in pos])
    return call


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_ue_softmodem_gives_jax_lines(monkeypatch):
    """At -n 1 -R 24 the port draws JAX's numpy inputs: its [sync] line (bar
    the seconds), its [mib] fields, its [data] count and its verdict are
    JAX's.  JAX's functions run compiled at optimization level 0, but the
    blind search, whose compile takes longer than its eager run."""
    rc, got = _run(ue_softmodem.main, ["-n", "1", "-R", "24", "--device", "cpu"])
    for mod, names in ((jsync, ("initial_sync", "ssb_time_signal")),
                       (jpbch, ("ssb_generate", "ssb_receive")),
                       (jpusch, ("pusch_tx_grid", "pusch_rx_grid")),
                       (jpdcch, ("pdcch_tx_grid",))):
        for name in names:
            monkeypatch.setattr(mod, name, _opt0(getattr(mod, name)))
    jrc, want = _run(jue_softmodem.main, ["-n", "1", "-R", "24"])
    assert rc == jrc == 0

    def norm(line):
        line = re.sub(r" \([0-9.]+s\)$", "", line)                    # [sync]'s seconds
        line = re.sub(r"Array\((-?\d+), dtype=int32\)", r"\1", line)   # JAX's scalars
        return line.split(" (median")[0]                               # [data]'s latency
    assert [norm(x) for x in got] == [norm(x) for x in want]
    assert got[0].startswith("[sync] n_id=17 (expected 17)") and "pbch_crc_ok=True" in got[0]
    assert got[-1] == "UE softmodem OK"


# ---- the UE MAC/PHY seam (tests/test_ue_fapi.py) ----

def test_ue_phy_seam_matches_jax():
    """UePhy.handle_ul composes JAX's UL slot (PUSCH + PUCCH F0, and a
    PRACH-only slot) and the gNB decodes it; handle_dl returns the MIB, the
    grant and the TB of a gNB slot (SSB + DCI + PDSCH)."""
    import jax.numpy as jnp
    from openairinterface5g_tpu.fapi import ue_if as jue_if
    from openairinterface5g_tpu.models import prach as jprach
    from openairinterface5g_tpu.models import pucch as jpucch
    from openairinterface5g_tpu_torch.config import make_frame_params
    from openairinterface5g_tpu_torch.fapi import ue_if
    from openairinterface5g_tpu_torch.models import gnb, pbch, pdcch, pdsch, prach, pucch, pusch
    from openairinterface5g_tpu_torch.models import ue as tue
    from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate

    bwp = 48
    kw = dict(mu=1, n_prb=24, prb_start=0, n_bwp_prb=bwp, mcs=4, n_symbols=13)
    tb = np.random.default_rng(3).integers(0, 2, (1, pusch.PuschConfig(**kw).tbs)).astype(np.int8)
    phy = ue_if.UePhy(mu=1, n_bwp_prb=bwp, device="cpu")
    p0 = pucch.Pucch0Config(n_bits=1, n_symbols=1, start_symbol=13)
    tx = phy.handle_ul(ue_if.UlConfigRequest(slot=0, pusch=(ue_if.UlPuschPdu(
        pusch.PuschConfig(**kw), torch.as_tensor(tb)),), pucch=(ue_if.UlPucchPdu(
            p0, torch.as_tensor([1]), prb=40),)))
    jp0 = jpucch.Pucch0Config(n_bits=1, n_symbols=1, start_symbol=13)
    want = _compiled(lambda t, u: jue_if.UePhy(mu=1, n_bwp_prb=bwp).handle_ul(
        jue_if.UlConfigRequest(slot=0, pusch=(jue_if.UlPuschPdu(jpusch.PuschConfig(**kw), t),),
                               pucch=(jue_if.UlPucchPdu(jp0, u, prb=40),))),
        jnp.asarray(tb), jnp.asarray([1]))
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(tx.numpy() - np.asarray(want)).max()) <= 1e-5 * scale
    ul = gnb.SlotUlConfig(mu=1, n_bwp_prb=bwp, pusch=(pusch.PuschConfig(**kw),),
                          pucch0=((p0, 40),))
    out = gnb.gnb_ul_slot(ul, tx, n_iters=10)
    assert bool(out["crc_indication"][0]["tb_ok"].all())
    np.testing.assert_array_equal(out["rx_data"][0].numpy(), tb)
    assert int(out["uci0"][0]["uci"][0]) == 1

    fp = make_frame_params(1, bwp)
    pk = dict(fmt="A2", mu=1, sample_rate=fp.sample_rate, roots=(1, 2, 3, 4), n_cs=23,
              threshold=8.0)
    pcfg = prach.PrachTdConfig(**pk)
    tx = phy.handle_ul(ue_if.UlConfigRequest(slot=1, prach=(ue_if.UlPrachPdu(pcfg, 17),)))
    want = jue_if.UePhy(mu=1, n_bwp_prb=bwp).handle_ul(jue_if.UlConfigRequest(
        slot=1, prach=(jue_if.UlPrachPdu(jprach.PrachTdConfig(**pk), 17),)))
    assert tx.shape == want.shape
    assert float(np.abs(tx.numpy() - np.asarray(want)).max()) <= \
        1e-5 * float(np.abs(np.asarray(want)).max())
    det = prach.prach_td_rx(pcfg, tx[:, :, : pcfg.n_samples])
    assert bool(det["detected"][0]) and int(det["preamble"][0]) == 17

    rnti, cell = 0x1234, 31
    pd = pdsch.PdschConfig(mu=1, n_prb=12, prb_start=24, n_bwp_prb=bwp, mcs=9, rnti=rnti,
                           n_id=cell, start_symbol=2, n_symbols=12, dmrs_symbols=(2,))
    tb = torch.as_tensor(np.random.default_rng(2).integers(0, 2, (1, pd.tbs)).astype(np.int8))
    dl = gnb.SlotDlConfig(
        mu=1, n_bwp_prb=bwp, pdsch=(pd,),
        ssb=gnb.SsbPdu(pbch.PbchConfig(n_id=cell), prb_offset=1, start_symbol=8),
        pdcch=(gnb.PdcchPdu(pdcch.DciConfig(A=tue.DCI_A, rnti=rnti, n_id=cell, coreset_prb=24,
                                            aggregation_level=4)),))
    grant = torch.as_tensor(tue.encode_grant(mcs=9, prb_start=24, n_prb=12)[None])
    tx, _ = gnb.gnb_dl_slot(dl, [tb], torch.as_tensor(pbch.mib_payload(pbch.Mib(), sfn=0)[None]),
                            dci_payloads=[grant])
    ind = phy.handle_dl(ue_if.DlConfigRequest(
        slot=0, dci=(ue_if.DlDciSearch(rnti=rnti, coreset_prb=24, n_id=cell),),
        ssb=ue_if.DlSsbSearch(n_id=cell, prb_offset=1, start_symbol=8)),
        extract_from_grid(fp, ofdm_demodulate(fp, tx, 0)))
    assert ind.mib is not None and int(ind.mib["sfn"]) == 0
    assert ind.dci and ind.dci[0]["mcs"] == 9 and ind.dci[0]["rnti"] == rnti
    bits, ok = ind.pdsch[0]
    assert bool(ok.all()) and torch.equal(bits, tb)


# ---- the IF4p5 split ----

def test_if4p5_codec_gives_jax_bytes():
    rng = np.random.default_rng(0)
    iq = ((rng.normal(size=600) + 1j * rng.normal(size=600)) * 3.7).astype(np.complex64)
    buf = if4p5.pack(if4p5.If4p5Packet(if4p5.UL_FD, 12, 3, 5, 1, 42, iq))
    assert buf == jif4p5.pack(jif4p5.If4p5Packet(jif4p5.UL_FD, 12, 3, 5, 1, 42, iq))
    q, jq = if4p5.unpack(buf), jif4p5.unpack(buf)
    assert (q.frame, q.slot, q.symbol, q.antenna, q.seq) == (12, 3, 5, 1, 42)
    np.testing.assert_array_equal(q.iq, jq.iq)
    assert np.abs(q.iq - iq).max() / np.abs(iq).max() < 1e-3


def _wait_bound(port: int) -> None:
    """Until a UDP socket holds 127.0.0.1:port (read from /proc/net/udp, so
    the check never takes the port itself)."""
    want = f"0100007F:{port:04X}"
    for _ in range(200):
        rows = pathlib.Path("/proc/net/udp").read_text().splitlines()[1:]
        if any(row.split()[1] == want for row in rows):
            return
        time.sleep(0.05)
    raise TimeoutError(f"nothing bound UDP port {port}")


def test_ru_l1_split_on_its_own_ports():
    """run_ru / run_l1 at 4 trials: the L1's BLER gate passes (UL 4/4, the 4
    DL slots through the split)."""
    lines, res = [], {}
    kw = dict(ru_port=48731, l1_port=48732, device="cpu")
    t = threading.Thread(target=lambda: res.__setitem__(
        "l1", ru_l1_split.run_l1(4, log=lines.append, **kw)), daemon=True)
    t.start()
    _wait_bound(48732)
    ru_l1_split.run_ru(4, log=lines.append, **kw)
    t.join(timeout=300)
    assert res["l1"] is True, lines
    assert "[l1] UL through IF4p5 split: BLER 0.000000 (4/4)" in lines
    assert "[l1] DL through IF4p5 split: 4/4 ok" in lines and lines[-1] == "PUSCH test OK"
