"""The port's L3 against the JAX package's, on the CPU: the copied protocol
modules (RRC, NAS, NGAP, GTP-U, F1AP, E1AP, SCTP framing, E2AP, XnAP,
X2AP); cases after tests/test_l3.py, tests/test_l3_ext.py and
tests/test_connected_ota.py::test_gtpu_to_drb_user_plane.

The copies' code equals the originals' (docstrings aside).  Each exchange
runs once on each package with every PDU on its wires logged: the port's
run must pass the JAX test's checks and its PDUs must equal JAX's, byte for
byte.  ``os.urandom`` (the RRCSetupRequest's ue_identity) is pinned for both.
"""
import ast
import importlib
import pathlib
import time
import types

import pytest
import torch

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("openairinterface5g_tpu", "openairinterface5g_tpu_torch")
L3 = ("rrc", "nas", "ngap", "gtpu", "f1ap", "e1ap", "sctp", "e2ap", "xnap", "x2ap")


def _code(path: pathlib.Path) -> str:
    """The module's AST without its docstring."""
    tree = ast.parse(path.read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("name", L3)
def test_copies_equal_originals(name):
    rel = pathlib.Path("l3") / f"{name}.py"
    assert _code(ROOT / PACKAGES[1] / rel) == _code(ROOT / PACKAGES[0] / rel)


def _pkg(root: str):
    """The L3 modules (and the L2 ones the flows use) of one package."""
    ns = {n: importlib.import_module(f"{root}.l3.{n}") for n in L3 + ("per",)}
    ns.update({n: importlib.import_module(f"{root}.l2.{n}")
               for n in ("ue_mac", "pdcp", "rlc", "userplane")})
    return types.SimpleNamespace(root=root, **ns)


@pytest.fixture
def pinned(monkeypatch):
    """os.urandom as a counter, the same bytes for both packages' runs."""
    def run(flow):
        out = []
        for root in PACKAGES:
            state = {"n": 0}

            def urandom(n):
                state["n"] += 1
                return bytes((state["n"] * 37 + i) & 0xFF for i in range(n))
            monkeypatch.setattr("os.urandom", urandom)
            out.append(flow(_pkg(root)))
        jax_wire, port_wire = out
        assert port_wire == jax_wire
        assert port_wire, "the exchange sent no PDU"
        return port_wire
    return run


def _tap(wire: list, tag: str, fn):
    """fn, logging (tag, args) on the wire first."""
    def send(*args):
        wire.append((tag, *args))
        return fn(*args)
    return send


def test_per_roundtrip(pinned):
    def flow(m):
        per = m.per
        schema = per.Seq((
            ("a", per.Int(0, 100), False),
            ("b", per.Enum(("x", "y", "z")), False),
            ("c", per.OctStr(), True),
            ("d", per.SeqOf(per.Int(0, 15)), False),
            ("e", per.BitStr(20), False),
        ))
        v = {"a": 42, "b": "z", "c": b"hello", "d": [1, 2, 3], "e": 0xABCDE >> 4}
        wire = [per.encode(schema, v), per.encode(schema, dict(v, c=None))]
        assert per.decode(schema, wire[0]) == v
        assert per.decode(schema, wire[1]) == dict(v, c=None)
        return wire
    pinned(flow)


def test_rrc_setup_flow(pinned):
    def flow(m):
        wire = []
        gnb = m.rrc.GnbRrc(cell_id=7)
        ue = m.rrc.UeRrc()
        gnb.send_dl = _tap(wire, "dl", lambda rnti, srb, pdu: ue.handle_dl(srb, pdu))
        ue.send_ul = _tap(wire, "ul", lambda srb, pdu: gnb.handle_ul(0x46, pdu))
        nas_up = []
        gnb.nas_upstream = lambda rnti, pdu: nas_up.append((rnti, pdu))
        ue.connect(nas_pdu=b"REG")
        assert ue.state == "CONNECTED" and gnb.ue[0x46].state == "CONNECTED"
        assert nas_up == [(0x46, b"REG")]
        gnb.start_security(0x46)
        assert ue.security_on and gnb.ue[0x46].security_on
        gnb.setup_drb(0x46, drb_id=2)
        assert ue.drbs == [2] and gnb.ue[0x46].state == "RB_CONFIGURED"
        gnb.release(0x46)
        assert ue.state == "IDLE" and 0x46 not in gnb.ue
        names = [(m.rrc.decode_ul if x[0] == "ul" else m.rrc.decode_dl)(x[-1])[0]
                 for x in wire]
        assert names == ["rrcSetupRequest", "rrcSetup", "rrcSetupComplete",
                         "securityModeCommand", "securityModeComplete", "rrcReconfiguration",
                         "rrcReconfigurationComplete", "rrcRelease"]
        return wire
    pinned(flow)


def _registration(m, wire):
    amf, ue = m.nas.AmfStub(), m.nas.UeNas()
    pending = [ue.start()]
    while pending:
        wire.append(("ul", pending[0]))
        for reply in amf.handle(pending.pop(0)):
            wire.append(("dl", reply))
            pending.extend(ue.handle(reply))
    return amf, ue


def test_nas_registration_flow(pinned):
    def flow(m):
        wire = []
        amf, ue = _registration(m, wire)
        assert amf.state == "SESSION" and ue.state == "SESSION" and ue.ip == "10.0.0.2"
        return wire
    pinned(flow)


def test_nas_service_and_release_procedures(pinned):
    """24.501 §5.5.2/5.6/6.3: GUTI reallocation, identity, session
    modification and release, service request, de-registration."""
    def flow(m):
        nas, wire = m.nas, []
        amf, ue = _registration(m, wire)
        assert ue.state == "SESSION" and ue.ip is not None

        def exchange(pdu):
            wire.append(("ul", pdu))
            for reply in amf.handle(pdu):
                wire.append(("dl", reply))
                for done in ue.handle(reply):
                    wire.append(("ul", done))
                    amf.handle(done)

        cmd = nas.configuration_update_command(b"\x07" * 11)
        replies = ue.handle(cmd)
        wire += [("dl", cmd), *[("ul", r) for r in replies]]
        assert ue.guti == b"\x07" * 11
        assert nas.decode(replies[0]).msg_type == nas.MSG_CONFIG_UPDATE_COMPLETE
        replies = ue.handle(nas.identity_request())
        wire += [("dl", nas.identity_request()), *[("ul", r) for r in replies]]
        assert nas.decode(replies[0]).msg_type == nas.MSG_IDENTITY_RESPONSE
        exchange(ue.request_session_modification(qos=b"\x09"))
        assert ue.qos == b"\x09"
        exchange(ue.request_session_release())
        assert ue.ip is None and ue.state == "REGISTERED" and amf.state == "REGISTERED"
        exchange(ue.request_service())
        assert ue.state == "REGISTERED"
        exchange(ue.request_deregistration())
        assert ue.state == "DEREGISTERED" and amf.state == "DEREGISTERED"
        return wire
    pinned(flow)


def test_ngap_closed_loop_with_nas(pinned):
    def flow(m):
        wire = []
        ue_nas = m.nas.UeNas()
        dl_nas = []
        gnb = m.ngap.GnbNgap(nas_downstream=lambda rnti, pdu: dl_nas.append((rnti, pdu)))
        amf = m.ngap.AmfNgapStub(nas_handler=m.nas.AmfStub())
        gnb.send = _tap(wire, "n2 ul", amf.handle)
        amf.send = _tap(wire, "n2 dl", gnb.handle)
        gnb.ng_setup()
        assert gnb.setup_done
        ran_id = gnb.initial_ue_message(0x46, ue_nas.start())
        for _ in range(10):
            if not dl_nas:
                break
            _, pdu = dl_nas.pop(0)
            for up in ue_nas.handle(pdu):
                gnb.uplink_nas(ran_id, up)
        assert ue_nas.state == "SESSION"
        assert gnb.ue[ran_id]["sessions"], "PDU session resources set up"
        return wire
    pinned(flow)


def test_gtpu_roundtrip(pinned):
    def flow(m):
        wire = []
        pkt = m.gtpu.encode_gpdu(0x1234, b"ip-packet", seq=7)
        hdr, payload = m.gtpu.decode(pkt)
        assert hdr.teid == 0x1234 and hdr.seq == 7 and payload == b"ip-packet"
        got = []
        b = m.gtpu.GtpuEndpoint(deliver=lambda sid, p: got.append((sid, p)))
        a = m.gtpu.GtpuEndpoint(transport=_tap(wire, "n3", b.receive))
        a.add_session(1, local_teid=0x10, remote_teid=0x20)
        b.add_session(1, local_teid=0x20, remote_teid=0x10)
        a.send(1, b"hello-up")
        assert got == [(1, b"hello-up")]
        return [pkt, *wire]
    pinned(flow)


def test_sctp_framing_loopback_and_tcp():
    """The port's framing over a socketpair and over TCP on port 0; every
    wait bounded, every thread joined."""
    sctp = importlib.import_module("openairinterface5g_tpu_torch.l3.sctp")
    jsctp = importlib.import_module("openairinterface5g_tpu.l3.sctp")
    assert (sctp.PPID_NGAP, sctp.PPID_F1AP, sctp.PPID_E1AP) == \
        (jsctp.PPID_NGAP, jsctp.PPID_F1AP, jsctp.PPID_E1AP)
    assert sctp._HDR.pack(1, 0, sctp.PPID_NGAP, 8) == jsctp._HDR.pack(1, 0, jsctp.PPID_NGAP, 8)

    def wait_for(cond):
        deadline = time.time() + 5
        while not cond() and time.time() < deadline:
            time.sleep(0.01)

    got_a, got_b = [], []
    a, b = sctp.loopback_pair(lambda *m: got_a.append(m), lambda *m: got_b.append(m))
    try:
        a.send(0, sctp.PPID_NGAP, b"ngap-pdu")
        b.send(1, sctp.PPID_F1AP, b"f1ap-pdu")
        wait_for(lambda: got_a and got_b)
        assert got_b == [(0, sctp.PPID_NGAP, b"ngap-pdu")]
        assert got_a == [(1, sctp.PPID_F1AP, b"f1ap-pdu")]
    finally:
        a.close()
        b.close()
    for assoc in (a, b):
        assoc._thread.join(timeout=5)
        assert not assoc._thread.is_alive()

    got_srv = []
    holder, port, t = sctp.listen(0, lambda *m: got_srv.append(m))
    cli = sctp.connect("127.0.0.1", port, lambda *m: None)
    cli.sock.settimeout(5)
    try:
        cli.send(0, sctp.PPID_E1AP, b"e1")
        wait_for(lambda: got_srv)
        assert got_srv == [(0, sctp.PPID_E1AP, b"e1")]
    finally:
        cli.close()
        t.join(timeout=5)
        if "assoc" in holder:
            holder["assoc"].close()
            holder["assoc"]._thread.join(timeout=5)
    assert not t.is_alive()


def test_f1ap_cu_du_split_rrc(pinned):
    """RRC setup through the F1 split: UE <-> DU <-> CU."""
    def flow(m):
        wire = []
        ue = m.rrc.UeRrc()
        rrc = m.rrc.GnbRrc(cell_id=3)
        cu = m.f1ap.CuF1ap(rrc)
        du = m.f1ap.DuF1ap(du_id=9, cell_id=3,
                           deliver_dl=lambda rnti, srb, pdu: ue.handle_dl(srb, pdu))
        cu.send = _tap(wire, "f1 dl", du.handle)
        du.send = _tap(wire, "f1 ul", cu.handle)
        du.f1_setup()
        assert du.setup_done
        first = [True]

        def ue_ul(srb, pdu):
            if first[0]:
                first[0] = False
                du.initial_ul_rrc(0x46, pdu)
            else:
                du.ul_rrc(0x46, srb, pdu)

        ue.send_ul = ue_ul
        ue.connect(nas_pdu=b"REG")
        assert ue.state == "CONNECTED" and rrc.ue[0x46].state == "CONNECTED"
        cu.setup_drb(0x46, drb_id=1)
        assert ue.drbs == [1] and rrc.ue[0x46].state == "RB_CONFIGURED"
        return wire
    pinned(flow)


def test_e1ap_bearer_context(pinned):
    def flow(m):
        wire = []
        cp = m.e1ap.CuCpE1ap()
        up = m.e1ap.CuUpE1ap(cu_up_id=5)
        cp.send = _tap(wire, "e1 cp", up.handle)
        up.send = _tap(wire, "e1 up", cp.handle)
        up.e1_setup()
        assert cp.setup_done
        cp.setup_bearer(cu_cp_ue_id=1, pdu_session_id=1, drb_id=1, ul_teid=0x2000)
        assert 1 in cp.contexts
        assert cp.contexts[1]["dl_teid"] == \
            up.bearers[cp.contexts[1]["cu_up_ue_id"]]["dl_teid"]
        return wire
    pinned(flow)


def test_ue_mac_random_access(pinned):
    def flow(m):
        ue = m.ue_mac.UeMac()
        req = ue.start_ra(slot=0, msg3_payload=b"RRCSetupRequest")
        assert req["preamble_index"] == ue.ra.preamble_index
        assert ue.on_rar(5, {"preamble_index": 3, "tc_rnti": 0x41}) is None
        msg3 = ue.on_rar(5, {"preamble_index": req["preamble_index"],
                             "tc_rnti": 0x41, "ul_grant": 56})
        assert msg3["rnti"] == 0x41 and msg3["payload"] == b"RRCSetupRequest"
        assert ue.on_contention_resolution(0x41, b"RRCSetupRequest...")
        assert ue.state == "CONNECTED" and ue.c_rnti == 0x41
        return [sorted(req.items()), sorted(msg3.items())]
    pinned(flow)


def test_ue_mac_ra_timeout_and_bsr(pinned):
    def flow(m):
        ue = m.ue_mac.UeMac()
        ue.start_ra(slot=0)
        assert ue.ra_timeout(ue.ra.response_window_slots + 1)
        assert ue.state == "IDLE"
        ue.push_ul_data(5000)
        bsr = ue.bsr()
        assert bsr > 0
        filled = ue.on_ul_grant(tbs_bytes=1000)
        assert filled["data_bytes"] == 998 and ue.ul_buffer == 5000 - 998
        return [bsr, sorted(filled.items())]
    pinned(flow)


def test_e2ap_kpm_loop(pinned):
    def flow(m):
        wire = []
        stats = {"ues": [{"rnti": 0x46, "dl_tput_mbps": 42.0, "mcs": 16}]}
        controls = []
        agent = m.e2ap.E2Agent(gnb_id=7, stats_provider=lambda: stats,
                               control_sink=controls.append)
        ric = m.e2ap.RicStub()
        agent.send = _tap(wire, "e2 agent", ric.handle)
        ric.send = _tap(wire, "e2 ric", agent.handle)
        agent.e2_setup()
        assert agent.setup_done and ric.functions == [2, 3]
        ric.subscribe(period_ms=100)
        agent.tick()
        agent.tick()
        assert len(ric.indications) == 2 and ric.indications[0]["ues"][0]["rnti"] == 0x46
        ric.control({"max_mcs": 9})
        assert controls == [{"max_mcs": 9}]
        return wire
    pinned(flow)


def test_xnap_handover(pinned):
    def flow(m):
        wire = []
        src = m.xnap.XnEndpoint(gnb_id=1, cells=[101])
        tgt = m.xnap.XnEndpoint(gnb_id=2, cells=[202])
        src.send = _tap(wire, "xn src", tgt.handle)
        tgt.send = _tap(wire, "xn tgt", src.handle)
        src.xn_setup()
        assert src.setup_done and src.peer_cells == [202]
        src.start_handover(ue_id=9, target_cell=202, c_rnti=0x46,
                           ue_context=b"rrc-ctx", sn_dl=100, sn_ul=50)
        assert 9 in src.pending_ho and "ack" in src.pending_ho[9]
        assert src.completed == [9]
        tid = src.pending_ho[9]["ack"]["target_ue_id"]
        assert tgt.admitted[tid]["context"] == b"rrc-ctx"
        assert tgt.admitted[tid]["c_rnti"] == 0xC000 + tid
        return wire
    pinned(flow)


def test_x2ap_handover_and_endc(pinned):
    """X2 handover between two eNBs, a preparation failure, EN-DC SgNB
    addition."""
    def flow(m):
        log, wire_a, wire_b = [], [], []
        a = m.x2ap.X2Endpoint(1, cells=[0x100], send=wire_a.append)
        b = m.x2ap.X2Endpoint(2, cells=[0x200], send=wire_b.append)

        def pump(peer_b=b):
            while wire_a or wire_b:
                for pdu in wire_a[:]:
                    wire_a.remove(pdu)
                    log.append(("a", pdu))
                    peer_b.handle(pdu)
                for pdu in wire_b[:]:
                    wire_b.remove(pdu)
                    log.append(("b", pdu))
                    a.handle(pdu)

        a.x2_setup()
        pump()
        assert a.setup_done and a.peer_cells == [0x200]
        a.start_handover(7, target_cell=0x200, ue_context=b"rrc-ctx", erabs=(5, 6))
        pump()
        assert a.completed == [7]
        tid = a.pending_ho[7]["ack"]["new_ue_x2ap_id"]
        assert b.admitted[tid]["context"] == b"rrc-ctx"
        assert b.admitted[tid]["pdcp_sn_dl"] == 100
        b2 = m.x2ap.X2Endpoint(3, cells=[0x300], send=wire_b.append, admit=lambda msg: False)
        a.start_handover(8, target_cell=0x300, ue_context=b"x")
        pump(peer_b=b2)
        assert a.failed == [8]
        a.start_sgnb_addition(9, nr_cell=0xABC)
        pump()
        assert a.sgnb[9]["scg"] == b"nr-scg-config"
        return log
    pinned(flow)


def test_gtpu_to_drb_user_plane(pinned):
    """tests/test_connected_ota.py::test_gtpu_to_drb_user_plane over the
    port's l2/userplane.py: an N3 G-PDU decapsulated into the DRB (PDCP NEA2,
    RLC AM, MAC framing) over a lossy TB channel, the UL packet
    re-encapsulated toward the core; every TB and GTP-U packet logged."""
    def flow(m):
        log = []
        gnb_drb = m.userplane.DrbStack(m.pdcp.DIR_DL)
        ue_drb = m.userplane.DrbStack(m.pdcp.DIR_UL)
        gnb_gtp = m.gtpu.GtpuEndpoint(deliver=lambda sid, pay: gnb_drb.send_packet(pay))
        gnb_gtp.add_session(5, local_teid=0x1111, remote_teid=0x2222)
        ip_pkt = b"E\x00\x01\x00" + bytes(range(128)) * 2
        n3 = m.gtpu.encode_gpdu(0x1111, ip_pkt)
        log.append(n3)
        gnb_gtp.receive(n3)
        lost = gnb_drb.fill_tb(200)
        assert lost is not None
        log.append(lost)

        def hop(src, dst, n):
            tb = src.fill_tb(n)
            log.append(tb)
            dst.drain_tb(tb)

        for _ in range(8):
            hop(ue_drb, gnb_drb, 120)
            hop(gnb_drb, ue_drb, 200)
        assert ue_drb.delivered and ue_drb.delivered[0] == ip_pkt
        up = b"E\x00\x00\x40" + bytes(60)
        ue_drb.send_packet(up)
        for _ in range(6):
            hop(ue_drb, gnb_drb, 200)
            hop(gnb_drb, ue_drb, 120)
        assert gnb_drb.delivered and gnb_drb.delivered[0] == up
        n1_pkt = gnb_gtp.send(5, gnb_drb.delivered[0])
        if n1_pkt is not None:
            hdr, inner = m.gtpu.decode(n1_pkt)
            assert inner == up and hdr.teid == 0x2222
        log.append(n1_pkt)
        return log
    pinned(flow)
