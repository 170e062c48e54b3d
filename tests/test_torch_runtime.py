"""The port's NR runtime layer against the JAX package's, on the CPU: the
copied modules (TDD patterns, the phytest and PF schedulers, FAPI, L2, the
UE MAC, the IQ player, the IF4p5 codec), the slot executor and the
nr-softmodem loop; cases after tests/test_tdd.py, test_l2.py,
test_rlc_am.py, test_fapi.py and test_runtime.py.

The copies' code equals the originals' (docstrings aside); the L2 and FAPI
cases run once on each package.  The softmodem's AWGN comes from a
torch.Generator, so its lines are held where the noise does not move them
(the header, the TDD pattern, the verdict at JAX's test SNR); JAX's loop is
not run here, tests/test_runtime.py runs it.
"""
import ast
import contextlib
import dataclasses
import io
import pathlib
import threading

import numpy as np
import pytest
import torch

import openairinterface5g_tpu.fapi.messages as jmsg
import openairinterface5g_tpu.fapi.transport as jtransport
import openairinterface5g_tpu.l2.mac as jmac
import openairinterface5g_tpu.l2.pdcp as jpdcp
import openairinterface5g_tpu.l2.rlc as jrlc
import openairinterface5g_tpu.l2.sdap as jsdap
import openairinterface5g_tpu.l2.security as jsec
import openairinterface5g_tpu.l2.ue_mac as jue_mac
import openairinterface5g_tpu.models.ue as jue
import openairinterface5g_tpu.runtime.executor as jexec
import openairinterface5g_tpu.runtime.scheduler as jsched
import openairinterface5g_tpu.runtime.tdd as jtdd
from openairinterface5g_tpu.models.pusch import PuschConfig as JPuschConfig
from openairinterface5g_tpu_torch.fapi import messages as tmsg
from openairinterface5g_tpu_torch.fapi import transport as ttransport
from openairinterface5g_tpu_torch.l2 import mac as tmac
from openairinterface5g_tpu_torch.l2 import pdcp as tpdcp
from openairinterface5g_tpu_torch.l2 import rlc as trlc
from openairinterface5g_tpu_torch.l2 import sdap as tsdap
from openairinterface5g_tpu_torch.l2 import security as tsec
from openairinterface5g_tpu_torch.l2 import ue_mac as tue_mac
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.models import ue as tue
from openairinterface5g_tpu_torch.runtime import (connected_ota, executor, ra_ota,
                                                  ru_l1_split, scheduler, softmodem, tdd,
                                                  ue_softmodem)
from openairinterface5g_tpu_torch.utils import profiling

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = pathlib.Path(__file__).resolve().parents[1]

COPIES = ["runtime/tdd.py", "runtime/scheduler.py", "fapi/__init__.py", "fapi/messages.py",
          "fapi/transport.py", "l2/__init__.py", "l2/mac.py", "l2/ue_mac.py",
          "l2/security.py", "l2/pdcp.py", "l2/rlc.py", "l2/sdap.py", "l2/userplane.py",
          "radio/iqplayer.py", "fronthaul/__init__.py", "fronthaul/if4p5.py"]


def _code(path: pathlib.Path) -> str:
    """The module's AST without its docstring."""
    tree = ast.parse(path.read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_originals(rel):
    assert _code(ROOT / "openairinterface5g_tpu_torch" / rel) == \
        _code(ROOT / "openairinterface5g_tpu" / rel)


# ---- TDD patterns (tests/test_tdd.py) ----

@pytest.mark.parametrize("spec", ["7,6,2,4", "3,6,1,4,2.5", "8,0,2,0", "4,10,4,2", "2,2,1,4,2.5"])
def test_tdd_patterns_match_jax(spec):
    t, j = tdd.TddConfig.from_string(spec), jtdd.TddConfig.from_string(spec)
    assert t.period_slots == j.period_slots
    assert t.pattern() == j.pattern()
    assert t.mixed_slot_symbols() == j.mixed_slot_symbols()
    assert [t.slot_type(s) for s in range(3 * t.period_slots)] == \
        [j.slot_type(s) for s in range(3 * j.period_slots)]
    if spec == "7,6,2,4":
        assert t.pattern() == "DDDDDDDSUU"
        assert t.mixed_slot_symbols() == ((0, 1, 2, 3, 4, 5), (10, 11, 12, 13))


def test_lte_tdd_counts_match_jax():
    assert tdd.LTE_TDD_CONFIGS == jtdd.LTE_TDD_CONFIGS
    for c in range(7):
        assert tdd.lte_tdd_counts(c) == jtdd.lte_tdd_counts(c)
    assert tdd.lte_tdd_counts(1) == (4, 2, 4) and tdd.lte_tdd_counts(5) == (8, 1, 1)


# ---- the phytest scheduler (runtime/scheduler.py) ----

def test_phytest_scheduler_matches_jax():
    """Fixed allocations, the HARQ rv sequence and the drop after max rounds,
    over a scripted run of CRC indications."""
    kw = [dict(mu=1, n_prb=24, prb_start=24 * i, n_bwp_prb=72, mcs=9 + i, rnti=0x1000 + i)
          for i in range(3)]
    t = scheduler.PhytestScheduler([tpusch.PuschConfig(**k) for k in kw])
    j = jsched.PhytestScheduler([JPuschConfig(**k) for k in kw])
    script = [(0, True), (1, False), (1, False), (2, False), (1, False), (1, False),
              (1, True), (0, False), (0, True)]
    for slot, (ue_idx, ok) in enumerate(script):
        (tul, tplans), (jul, jplans) = t.schedule_slot(slot), j.schedule_slot(slot)
        assert (tul.mu, tul.n_bwp_prb, tul.slot) == (jul.mu, jul.n_bwp_prb, jul.slot)
        for tc, jc in zip(tul.pusch, jul.pusch, strict=True):
            for f in ("n_prb", "prb_start", "mcs", "rnti", "slot", "tbs", "bwp_prbs"):
                assert getattr(tc, f) == getattr(jc, f), f
        assert [(p["rv"], p["new_data"]) for p in tplans] == \
            [(p["rv"], p["new_data"]) for p in jplans]
        t.handle_crc_indication(ue_idx, ok)
        j.handle_crc_indication(ue_idx, ok)
    assert t.stats() == j.stats()
    assert scheduler.HARQ_RV_SEQ == jsched.HARQ_RV_SEQ == (0, 2, 3, 1)


# ---- the PF scheduler (l2/mac.py) against JAX's over a scripted run ----

def test_mac_scheduler_matches_jax():
    """Every DL_TTI, UL_TTI and TX_DATA request of a scripted run (CRC, ACK,
    CQI and BSR indications, a RACH, a TDD pattern) packs to JAX's bytes."""
    def script(m, p):
        cfg = m.SchedulerConfig(n_bwp_prb=106, target_bler=0.2, sib1_payload=b"SIB1",
                                sib1_period_frames=4,
                                tdd=p["tdd"].TddConfig.from_string("7,6,2,4"))
        s = m.MacScheduler(cfg)
        a = s.add_ue(0x46, cqi=12, dl_buffer=50000, ul_buffer=10000)
        s.add_ue(0x47, cqi=5, dl_buffer=500)
        s.on_rach(p["msg"].RachIndication(preambles=((23, 100, -5),)))
        out = []
        for slot in range(40):
            sfn, sl = divmod(slot, 10)
            dl, ul, txd = s.schedule_slot(sfn, sl)
            out.append(b"".join(p["msg"].pack_message(x) for x in (dl, ul, txd)))
            for q in ul.pusch:
                s.on_crc(p["msg"].CrcIndication(
                    sfn=sfn, slot=sl, crcs=((q.handle, q.rnti, q.harq_process_id,
                                             slot % 3 != 0),)), ul=True)
            for q in dl.pdsch:
                if q.rnti in s.ues:
                    s.on_dl_ack(q.rnti, q.harq_process_id, slot % 4 != 1)
            if slot % 8 == 0:
                s.on_uci_cqi(0x46, 7 + slot % 9)
            s.on_bsr(0x47, 2000 if slot % 5 == 0 else 0)
            a.dl_buffer = 1 << 16
        out.append(repr((a.mcs_offset, a.cqi, s.ra_queue)).encode())
        return out

    got = script(tmac, {"msg": tmsg, "tdd": tdd})
    want = script(jmac, {"msg": jmsg, "tdd": jtdd})
    assert got == want
    assert tmac.HARQ_RV_SEQ == jmac.HARQ_RV_SEQ


# ---- L2 cases of tests/test_l2.py and test_rlc_am.py, on both packages ----

PKGS = {
    "jax": dict(mac=jmac, pdcp=jpdcp, rlc=jrlc, sdap=jsdap, sec=jsec, msg=jmsg,
                ue_mac=jue_mac, tdd=jtdd, ue=jue),
    "torch": dict(mac=tmac, pdcp=tpdcp, rlc=trlc, sdap=tsdap, sec=tsec, msg=tmsg,
                  ue_mac=tue_mac, tdd=tdd, ue=tue),
}
both = pytest.mark.parametrize("pk", list(PKGS.values()), ids=list(PKGS))


@both
def test_security_vectors(pk):
    sec = pk["sec"]
    ct = sec.Aes128(bytes.fromhex("000102030405060708090a0b0c0d0e0f")).encrypt_block(
        bytes.fromhex("00112233445566778899aabbccddeeff"))
    assert ct == bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    assert sec.aes_cmac(key, b"") == bytes.fromhex("bb1d6929e95937287fa37d129b756746")
    assert sec.aes_cmac(key, bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")) == \
        bytes.fromhex("070a16b46b4d4144f79bdd9dd04a287c")
    k2 = bytes.fromhex("d3c5d592327fb11c4035c6680af8c6d1")
    pt = bytes.fromhex("981ba6824c1bfb1ab485472029b71d808ce33e2cc3c0b5fc1f3de8a6dc66b1f0")
    assert sec.nea2(k2, 0x398a59b4, 0x15, 1, pt) == bytes.fromhex(
        "e9fed8a63d155304d71df20bf3e82214b20ed7dad2f233dc3c22d7bdeeed8e78")
    data = bytes(np.random.default_rng(0).integers(0, 256, 100, dtype=np.uint8))
    c = sec.nea2(bytes(range(16)), 7, 3, 1, data)
    assert c != data and sec.nea2(bytes(range(16)), 7, 3, 1, c) == data
    mac1 = sec.nia2(bytes(range(16)), 7, 3, 1, data)
    assert len(mac1) == 4 and sec.nia2(bytes(range(16)), 8, 3, 1, data) != mac1


def test_security_outputs_match_jax():
    rng = np.random.default_rng(5)
    for n in (0, 1, 15, 16, 17, 100, 333):
        key, data = bytes(rng.integers(0, 256, 16, dtype=np.uint8)), \
            bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert tsec.nea2(key, n, 3, 1, data) == jsec.nea2(key, n, 3, 1, data)
        assert tsec.nia2(key, n, 3, 0, data) == jsec.nia2(key, n, 3, 0, data)
        assert tsec.aes_cmac(key, data) == jsec.aes_cmac(key, data)


@both
def test_rlc_um(pk):
    rlc = pk["rlc"]
    got = []
    tx, rx = rlc.RlcUm(lambda d: None), rlc.RlcUm(got.append)
    sdu = bytes(range(200))
    tx.sdu_in(sdu)
    pdus = []
    while (p := tx.pdu_out(60)) is not None:
        pdus.append(p)
    assert len(pdus) >= 4
    for p in pdus:
        rx.pdu_in(p)
    assert got == [sdu]
    got.clear()
    rx = rlc.RlcUm(got.append, t_reassembly_slots=5)
    tx.sdu_in(bytes(100))
    pdus = []
    while (p := tx.pdu_out(40)) is not None:
        pdus.append(p)
    for i in (2, 0, 1):
        rx.pdu_in(pdus[i])
    assert got == [bytes(100)]
    got.clear()
    tx.sdu_in(bytes(100))
    pdus = []
    while (p := tx.pdu_out(40)) is not None:
        pdus.append(p)
    rx.pdu_in(pdus[0])
    rx.tick(100)
    assert got == [] and not rx.rx_segs


@both
def test_rlc_am_ack_retx_and_max_retx(pk):
    rlc = pk["rlc"]
    got, maxed = [], []
    a = rlc.RlcAm(lambda d: None, on_max_retx=maxed.append)
    b = rlc.RlcAm(got.append)
    sdus = [bytes([i]) * 20 for i in range(6)]
    for s in sdus:
        a.sdu_in(s)
    pdus = []
    while (p := a.pdu_out(100)) is not None:
        pdus.append(p)
    for i, p in enumerate(pdus):
        if i != 2:
            b.pdu_in(p)
    assert got == sdus[:2]
    a.pdu_in(b.status_out())
    b.pdu_in(a.pdu_out(100))
    assert got == sdus and not maxed
    m2 = []
    c = rlc.RlcAm(lambda d: None, max_retx=2, on_max_retx=m2.append)
    c.sdu_in(b"x" * 10)
    assert c.pdu_out(100) is not None
    for _ in range(4):
        c.retx.append(0)
        c.pdu_out(100)
    assert 0 in m2


def _am_link(tx, rx, grant, drop=None):
    n, idle = 0, 0
    while idle < 3:
        moved = False
        pdu = tx.pdu_out(grant)
        if pdu is not None:
            n += 1
            moved = True
            if not (drop and drop(n)):
                rx.pdu_in(pdu)
        st = rx.status_out()
        if st is not None:
            tx.pdu_in(st)
            moved = True
        st_tx = tx.status_out()
        if st_tx is not None:
            rx.pdu_in(st_tx)
        idle = 0 if moved else idle + 1
        assert n < 10000, "link did not converge"
    return n


@pytest.mark.parametrize("sn_bits,grant,drop", [(12, 64, None), (12, 16, None),
                                                (12, 40, (3, 7, 8)), (18, 50, (2,))])
def test_rlc_am_scenarios_match_jax(sn_bits, grant, drop):
    """RLC AM segmentation, loss and re-segmented retransmission: the same
    PDUs in the same order, the same SDUs delivered."""
    runs = []
    for rlc in (trlc, jrlc):
        out, pdus = [], []
        rx = rlc.RlcAm(out.append, sn_bits=sn_bits)
        tx = rlc.RlcAm(lambda b: None, sn_bits=sn_bits)
        real_out = tx.pdu_out

        def spy(g, real_out=real_out, pdus=pdus):
            p = real_out(g)
            pdus.append(p)
            return p
        tx.pdu_out = spy
        for i in range(5):
            tx.sdu_in(bytes([i]) * (50 + 40 * i))
        n = _am_link(tx, rx, grant, drop=(lambda k: k in drop) if drop else None)
        runs.append((out, pdus, n))
    assert runs[0] == runs[1]
    assert runs[0][0] == [bytes([i]) * (50 + 40 * i) for i in range(5)]


@both
@pytest.mark.parametrize("sn_bits", [12, 18])
def test_pdcp_ciphered_integrity(pk, sn_bits):
    pdcp = pk["pdcp"]
    got = []
    kw = dict(sn_bits=sn_bits, integrity=True, key_enc=bytes(range(16)),
              key_int=bytes(range(16, 32)))
    tx = pdcp.PdcpEntity(pdcp.PdcpConfig(direction=pdcp.DIR_DL, **kw), lambda d: None)
    rx = pdcp.PdcpEntity(pdcp.PdcpConfig(direction=pdcp.DIR_UL, **kw), got.append)
    msgs = [bytes([i]) * (10 + i) for i in range(5)]
    pdus = [tx.sdu_in(m) for m in msgs]
    for p in pdus:
        rx.pdu_in(p)
    assert got == msgs


def test_pdcp_pdus_match_jax():
    kw = dict(sn_bits=18, integrity=True, key_enc=bytes(range(16)), key_int=bytes(range(16, 32)))
    t = tpdcp.PdcpEntity(tpdcp.PdcpConfig(direction=tpdcp.DIR_DL, **kw), lambda d: None)
    j = jpdcp.PdcpEntity(jpdcp.PdcpConfig(direction=jpdcp.DIR_DL, **kw), lambda d: None)
    for i in range(6):
        m = bytes([i]) * (7 + 11 * i)
        assert t.sdu_in(m) == j.sdu_in(m)


@both
def test_pdcp_integrity_failure_and_reordering(pk):
    pdcp = pk["pdcp"]
    fails = []
    tx = pdcp.PdcpEntity(pdcp.PdcpConfig(integrity=True, direction=pdcp.DIR_DL), lambda d: None)
    rx = pdcp.PdcpEntity(pdcp.PdcpConfig(integrity=True, direction=pdcp.DIR_UL), lambda d: None,
                         on_integrity_fail=fails.append)
    pdu = bytearray(tx.sdu_in(b"hello world"))
    pdu[-1] ^= 0xFF
    assert rx.pdu_in(bytes(pdu)) is None and fails
    got = []
    tx = pdcp.PdcpEntity(pdcp.PdcpConfig(direction=pdcp.DIR_DL), lambda d: None)
    rx = pdcp.PdcpEntity(pdcp.PdcpConfig(direction=pdcp.DIR_UL), got.append)
    pdus = [tx.sdu_in(bytes([i]) * 8) for i in range(3)]
    rx.pdu_in(pdus[1])
    assert got == []
    rx.pdu_in(pdus[0])
    assert len(got) == 2
    rx.pdu_in(pdus[2])
    assert len(got) == 3


@both
def test_sdap_mapping(pk):
    sdap = pk["sdap"]
    sent, up = [], []
    ent = sdap.SdapEntity(sdap.SdapConfig(dl_header=True, ul_header=True),
                          lambda drb, d: sent.append((drb, d)), lambda qfi, d: up.append((qfi, d)))
    ent.map_flow(qfi=5, drb=2)
    ent.sdu_in(5, b"data")
    assert sent == [(2, bytes([0x80 | 5]) + b"data")]
    ent.pdu_in(2, bytes([0x80 | 5]) + b"uplink")
    assert up == [(5, b"uplink")]


@both
def test_mac_pf_harq_and_link_adaptation(pk):
    mac, msg = pk["mac"], pk["msg"]
    s = mac.MacScheduler(mac.SchedulerConfig(n_bwp_prb=106))
    s.add_ue(0x46, cqi=12, dl_buffer=50000, ul_buffer=10000)
    s.add_ue(0x47, cqi=5, dl_buffer=500)
    dl, ul, txd = s.schedule_slot(0, 0)
    assert len(dl.pdsch) == 2 and len(txd.payloads) == 2 and len(ul.pusch) == 1
    spans = sorted((p.rb_start, p.rb_start + p.rb_size) for p in dl.pdsch)
    assert all(a2 <= b1 for (_, a2), (b1, _) in zip(spans, spans[1:])) and spans[-1][1] <= 106
    by_rnti = {p.rnti: p for p in dl.pdsch}
    assert by_rnti[0x46].rb_size > by_rnti[0x47].rb_size
    s = mac.MacScheduler(mac.SchedulerConfig(n_bwp_prb=106))
    s.add_ue(0x46, cqi=9, ul_buffer=5000)
    _, ul, _ = s.schedule_slot(0, 0)
    pdu = ul.pusch[0]
    assert pdu.new_data == 1
    s.on_crc(msg.CrcIndication(crcs=((pdu.handle, 0x46, pdu.harq_process_id, False),)))
    _, ul2, _ = s.schedule_slot(0, 1)
    retx = [p for p in ul2.pusch if p.new_data == 0]
    assert retx and retx[0].rv == 2 and retx[0].harq_process_id == pdu.harq_process_id
    s.on_crc(msg.CrcIndication(crcs=((retx[0].handle, 0x46, retx[0].harq_process_id, True),)))
    assert not s.ues[0x46].ul_harq[pdu.harq_process_id].active
    s = mac.MacScheduler(mac.SchedulerConfig())
    ue = s.add_ue(0x46, cqi=12, ul_buffer=10 ** 6)
    for slot in range(30):
        _, ul, _ = s.schedule_slot(0, slot)
        for p in ul.pusch:
            s.on_crc(msg.CrcIndication(crcs=((p.handle, 0x46, p.harq_process_id, False),)))
    assert ue.mcs_offset < 0
    s.on_rach(msg.RachIndication(preambles=((23, 100, -5),)))
    assert s.ra_queue == [(23, 100)]


@both
def test_mac_sib1_paging_tdd_bwp_drx(pk):
    mac, tddm = pk["mac"], pk["tdd"]
    s = mac.MacScheduler(mac.SchedulerConfig(
        sib1_payload=b"SIB1-ENCODED", sib1_period_frames=16, drx_cycle_frames=32,
        paging_n=4, tdd=tddm.TddConfig.from_string("7,6,2,4")))
    ue = s.add_ue(0x4601)
    ue.dl_buffer = ue.ul_buffer = 500
    dl, _, txd = s.schedule_slot(sfn=16, slot=0)
    assert [p for p in dl.pdsch if p.rnti == mac.MacScheduler.SI_RNTI]
    assert txd.payloads[0] == b"SIB1-ENCODED"
    s.page_ue(5, b"PAGE-5")
    dl3, _, txd3 = s.schedule_slot(sfn=8, slot=1)
    assert [p for p in dl3.pdsch if p.rnti == mac.MacScheduler.P_RNTI]
    assert b"PAGE-5" in b"".join(txd3.payloads) and not s.paging_queue
    ue.dl_buffer = 500
    dl5, ul5, _ = s.schedule_slot(sfn=0, slot=8)
    assert not dl5.pdsch and ul5.pusch
    s = mac.MacScheduler(mac.SchedulerConfig(n_bwp_prb=106))
    ue = s.add_ue(0x31, cqi=9, bwps=((0, 48), (48, 58)))
    ue.dl_buffer = 1 << 20
    p = s.schedule_slot(0, 0)[0].pdsch[0]
    assert p.rb_start + p.rb_size <= 48
    s.on_dl_ack(0x31, p.harq_process_id, True)
    s.switch_bwp(0x31, 1)
    ue.dl_buffer = 1 << 20
    p2 = s.schedule_slot(0, 1)[0].pdsch[0]
    assert p2.rb_start >= 48 and p2.rb_start + p2.rb_size <= 106
    g = pk["ue"].decode_grant(pk["ue"].encode_grant(mcs=9, prb_start=48, n_prb=58, bwp=1))
    assert g["bwp"] == 1 and g["prb_start"] == 48
    s = mac.MacScheduler(mac.SchedulerConfig(n_bwp_prb=52))
    ue = s.add_ue(0x21, cqi=9, drx_cycle=16, drx_on_duration=2, drx_inactivity=3)

    def sched(slot):
        ue.dl_buffer = 1 << 16
        for h in ue.dl_harq:
            h.active = False
        return len(s.schedule_slot(0, slot)[0].pdsch) > 0
    assert sched(0) and sched(1) and sched(2) and sched(3)
    ue.drx_inactive_until = -1
    assert not sched(8) and not sched(15) and sched(16)


@both
def test_ue_mac_random_access(pk):
    um = pk["ue_mac"]
    mac = um.UeMac(um.RaConfig(preamble_index=9, max_attempts=3, response_window_slots=5))
    slot, retries = 0, 0
    while True:
        mac.start_ra(slot, b"REQ")
        slot = mac.window_end + 1
        if not mac.ra_timeout(slot):
            break
        retries += 1
    assert mac.state == "IDLE" and mac.attempts == 3 and retries == 2
    mac = um.UeMac(um.RaConfig(preamble_index=9))
    mac.start_ra(0, b"REQ")
    assert mac.on_rar(1, {"preamble_index": 4, "tc_rnti": 0x11}) is None
    assert mac.on_rar(2, {"preamble_index": 9, "tc_rnti": 0x22, "ul_grant": {}, "ta": 5})
    assert mac.on_contention_resolution(0x22, b"OTHER-UE-MSG3") is False
    mac.start_ra(20, b"REQ")
    mac.on_rar(21, {"preamble_index": 9, "tc_rnti": 0x44, "ul_grant": {}, "ta": 0})
    assert mac.on_contention_resolution(0x44, b"REQ") is True and mac.c_rnti == 0x44


# ---- FAPI (tests/test_fapi.py) ----

def _fapi_messages(m):
    return [
        m.ConfigRequest(mu=1, n_bwp_prb=273, n_cell_id=42, n_ant_dl=2, ssb_offset_point_a=12,
                        n_ant_ul=4),
        m.ConfigResponse(error_code=0), m.StartRequest(), m.StopRequest(),
        m.DlTtiRequest(sfn=12, slot=3,
                       pdsch=(m.PdschPdu(rnti=0x46, mcs=16, rb_size=273, n_layers=2,
                                         dmrs_symb_pos=(2, 11)),),
                       ssb=(m.SsbPduMsg(phys_cell_id=7, prb_offset=4, start_symbol=2),),
                       pdcch=(m.PdcchPdu(rnti=0x46, payload_bits=39,
                                         payload=bytes([1, 2, 3, 4, 5])),)),
        m.UlTtiRequest(sfn=1023, slot=19,
                       pusch=(m.PuschPduMsg(rnti=0x1234, mcs=9, rb_size=106, rv=2,
                                            harq_process_id=5, new_data=0),
                              m.PuschPduMsg(rnti=0x77, rb_start=50, rb_size=25,
                                            transform_precoding=1)),
                       pucch=(m.PucchPduMsg(rnti=0x88, format_type=0, prb_start=270,
                                            initial_cyclic_shift=6, n_bits=2),),
                       prach=(m.PrachPduMsg(prach_format=0, root_sequence_index=22),)),
        m.SlotIndication(sfn=5, slot=7),
        m.RxDataIndication(sfn=1, slot=2, pdus=((0, 0x46, b"\xde\xad\xbe\xef"),)),
        m.CrcIndication(sfn=1, slot=2, crcs=((0, 0x46, 3, True), (1, 0x77, 0, False))),
        m.UciIndication(sfn=1, slot=2, ucis=((0x88, 0, b"\x01", True),)),
        m.RachIndication(sfn=1, slot=2, preambles=((23, 144, -10),)),
        m.SrsIndication(sfn=1, slot=2, reports=((0x46, 1250),)),
        m.TxDataRequest(sfn=1, slot=2, payloads=(b"abc", b"", b"xyz")),
    ]


@pytest.mark.parametrize("i", range(13))
def test_fapi_messages_pack_to_jax_bytes(i):
    t, j = _fapi_messages(tmsg)[i], _fapi_messages(jmsg)[i]
    buf = tmsg.pack_message(t)
    assert buf == jmsg.pack_message(j)
    assert tmsg.unpack_message(buf) == t
    assert dataclasses.asdict(jmsg.unpack_message(buf)) == dataclasses.asdict(t)


def test_fapi_pusch_pdu_adapter_builds_the_ports_config():
    pdu = tmsg.PuschPduMsg(rnti=0x46, mcs=16, mcs_table=1, rb_start=10, rb_size=50,
                           n_layers=2, dmrs_symb_pos=(2, 11))
    cfg = tmsg.pusch_pdu_to_config(pdu, n_rx=2, n_bwp_prb=106)
    assert isinstance(cfg, tpusch.PuschConfig)
    jpdu = jmsg.PuschPduMsg(rnti=0x46, mcs=16, mcs_table=1, rb_start=10, rb_size=50,
                            n_layers=2, dmrs_symb_pos=(2, 11))
    jcfg = jmsg.pusch_pdu_to_config(jpdu, n_rx=2, n_bwp_prb=106)
    for f in ("n_prb", "prb_start", "n_layers", "dmrs_symbols", "tbs", "G", "n_rx"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    back = tmsg.config_to_pusch_pdu(cfg, rv=2, harq_id=3, new_data=False)
    assert back.rb_size == 50 and back.rv == 2 and back.harq_process_id == 3


def test_fapi_pnf_vnf_split_loopback():
    """The PNF/VNF split over UDP with a stub PHY (tests/test_fapi.py)."""
    m = tmsg
    pnf_ep, vnf_ep = ttransport.FapiEndpoint(), ttransport.FapiEndpoint()
    pnf_ep.connect(vnf_ep.addr)
    vnf_ep.connect(pnf_ep.addr)
    phy_log, got = [], []

    def phy_slot_fn(config, dl, ul, txd):
        phy_log.append((dl.slot, len(dl.pdsch), len(ul.pusch)))
        return [m.CrcIndication(sfn=ul.sfn, slot=ul.slot,
                                crcs=tuple((p.handle, p.rnti, p.harq_process_id, True)
                                           for p in ul.pusch))]

    def mac_slot_fn(sfn, slot):
        dl = m.DlTtiRequest(sfn=sfn, slot=slot,
                            pdsch=(m.PdschPdu(rnti=0x46),) if slot % 2 == 0 else ())
        ul = m.UlTtiRequest(sfn=sfn, slot=slot, pusch=(m.PuschPduMsg(rnti=0x46, handle=slot),))
        return dl, ul, m.TxDataRequest(sfn=sfn, slot=slot,
                                       payloads=(b"pay",) if dl.pdsch else ())

    pnf = ttransport.Pnf(pnf_ep, phy_slot_fn)
    vnf = ttransport.Vnf(vnf_ep, mac_slot_fn, on_indication=got.append)
    t = threading.Thread(target=lambda: (pnf.serve_control(), pnf.run_slots(4)))
    t.start()
    vnf.configure(m.ConfigRequest(mu=1, n_bwp_prb=106))
    vnf.run_slots(4)
    t.join(timeout=10)
    assert not t.is_alive() and len(phy_log) == 4
    crcs = [g for g in got if isinstance(g, m.CrcIndication)]
    assert len(crcs) == 4 and all(c.crcs[0][3] for c in crcs)
    pnf_ep.close()
    vnf_ep.close()
    assert jtransport.FapiEndpoint is not ttransport.FapiEndpoint


# ---- the slot executor ----

def test_executor_on_the_cpu():
    """Results in input order, on the host, one SlotStats per slot, and the
    report's wording (tests/test_runtime.py's pipeline case)."""
    ex = executor.SlotExecutor(lambda i, x: {"v": torch.sum(x * x) + i, "i": i}, depth=2,
                               device="cpu")
    results = ex.run([(torch.full((64, 64), float(i)),) for i in range(10)])
    assert [r["i"] for r in results] == list(range(10))
    for i, r in enumerate(results):
        assert abs(float(r["v"]) - (64 * 64 * i * i + i)) < 1e-3
    assert [s.slot for s in ex.stats] == list(range(10))
    assert all(0 <= s.dispatch_us <= s.complete_us for s in ex.stats)
    assert "over 10 slots" in ex.report()
    assert ex.run([(torch.zeros(1),)], collect=False) is None


def test_executor_on_the_cpu_copies_at_the_retire():
    """With device="cpu" the retire makes the host copy as before: results
    equal to the step's own, in pageable memory, one SlotStats a slot in
    order under collect=True and False alike, and a pinned share of 0 for
    every call while the tracer is on."""
    def step(i, x):
        return {"i": i, "bits": (x + i).to(torch.int8), "ok": [x[:4] > i]}
    xs = [(torch.arange(4096) % 7,) for _ in range(9)]
    ex = executor.SlotExecutor(step, depth=2, device="cpu")
    got = ex.run(xs)
    assert [r["i"] for r in got] == list(range(9))
    for i, r in enumerate(got):
        want = step(i, *xs[i])
        assert torch.equal(r["bits"], want["bits"]) and torch.equal(r["ok"][0], want["ok"][0])
        assert not r["bits"].is_pinned() and not r["ok"][0].is_pinned()
    kept = [(s.slot, s.deadline_miss) for s in ex.stats]
    assert kept == [(i, False) for i in range(9)]
    ex.stats.clear()
    profiling.reset()
    profiling.enable()
    try:
        assert ex.run(xs, collect=False) is None
    finally:
        profiling.disable()
    pinned = profiling.snapshot()["counts"]["runtime/executor.py:pinned"]
    profiling.reset()
    assert [(s.slot, s.deadline_miss) for s in ex.stats] == kept
    assert all(0 <= s.dispatch_us <= s.complete_us for s in ex.stats)
    assert [(r.call, r.total, r.n) for r in pinned] == [(i, 0.0, 1) for i in range(9)]


@pytest.mark.parametrize("budget", [None, 500e-6])
def test_executor_statistics_match_jax(budget):
    rng = np.random.default_rng(3)
    rows = [(i, float(d), float(d + c), bool(c > 1500))
            for i, (d, c) in enumerate(zip(rng.uniform(10, 90, 37), rng.uniform(100, 3000, 37)))]
    t = executor.SlotExecutor(lambda i: None, depth=2, slot_duration_s=budget, device="cpu")
    j = jexec.SlotExecutor(lambda i: None, depth=2, slot_duration_s=budget)
    assert t.report() == j.report() == "no slots executed"
    t.stats = [executor.SlotStats(*r) for r in rows]
    j.stats = [jexec.SlotStats(*r) for r in rows]
    assert t.percentiles() == j.percentiles()
    assert t.report() == j.report()


# ---- the nr-softmodem loop ----

def _softmodem(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = softmodem.main(argv)
    return rc, buf.getvalue().splitlines()


TINY = ["-n", "4", "-u", "1", "-P", "6", "-m", "4", "-s", "16", "-I", "6"]


@pytest.mark.parametrize("tdd_spec", [None, "7,6,2,4"])
def test_softmodem_loop_on_the_cpu(tdd_spec):
    """tests/test_runtime.py's loop arguments on the CPU: rc 0, "softmodem
    loop OK"; the header is JAX's, its TBS from JAX's PuschConfig."""
    argv = TINY + ["--device", "cpu"] + (["--tdd", tdd_spec, "-n", "10"] if tdd_spec else [])
    rc, out = _softmodem(argv)
    tbs = JPuschConfig(mu=1, n_prb=6, prb_start=0, n_bwp_prb=6, mcs=4, rnti=0x1000).tbs
    want = (f"softmodem loop: 1 UEs x 6 PRB MCS 4 TBS {tbs} @ 16.0 dB, backend=reference"
            + (", TDD pattern DDDDDDDSUU" if tdd_spec else ", FDD"))
    assert rc == 0 and out[0] == want, out
    assert out[-1] == "softmodem loop OK", out
    n_ul = 2 if tdd_spec else 4
    assert f"UL TB ok: {n_ul}/{n_ul}" in out[2] and f"over {10 if tdd_spec else 4} slots" in out[1]
    if tdd_spec:
        assert "[7 DL / 1 S / 2 UL]" in out[2]


def test_softmodem_tbs_are_jax_draws():
    """The loop's TBs are np.random.default_rng(0)'s draws in JAX's order:
    the UL slots' per UE, then the DL slots'."""
    args = softmodem.parse_args(TINY + ["-u", "2", "--device", "cpu", "--tdd", "1,0,1,0,1"])
    seen = []
    real = softmodem.pusch_tx

    def spy(cfg, tb, *a, **kw):
        seen.append(tb.numpy().copy())
        return real(cfg, tb, *a, **kw)
    softmodem.pusch_tx = spy
    try:
        r = softmodem.run(args, log=lambda *a: None)
    finally:
        softmodem.pusch_tx = real
    rng = np.random.default_rng(0)
    want = []
    for kind in r["kinds"]:
        n = r["tbs"] if kind == "U" else r["dl_tbs"]
        draws = [rng.integers(0, 2, (n,)).astype(np.int8) for _ in range(2)]
        if kind == "U":
            want.extend(d[None] for d in draws)
    assert len(seen) == len(want) == 2 * r["kinds"].count("U")
    assert all(np.array_equal(a, b) for a, b in zip(seen, want))


@pytest.mark.parametrize("main,argv", [(softmodem.main, []), (ue_softmodem.main, []),
                                       (ra_ota.main, ["gnb"]), (connected_ota.main, ["ue"]),
                                       (ru_l1_split.main, ["l1"])],
                         ids=["softmodem", "ue_softmodem", "ra_ota", "connected_ota",
                              "ru_l1_split"])
def test_entry_points_without_cuda_raise(monkeypatch, main, argv):
    """Every entry point runs on the card unless given --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
