"""The 5G SA call flow through the port against the JAX package's, on the
CPU: tests/test_e2e_callflow.py (the analog of the reference CI's
5g_rfsimulator attach and PDU-session test) at its own sizes, with its numpy
seed, run once with each package's PHY, L2 and L3.

  PRACH over the PHY -> RACH.indication -> RAR -> msg3 (an RRCSetupRequest
  in a real PUSCH transport block, 6 PRB, MCS 4, 12 iterations) -> RRC setup
  -> NAS registration and the PDU session through NGAP -> security -> a DRB
  over PDCP (NEA2/NIA2) and RLC UM -> GTP-U to the UPF stub.

The PRACH detection (preamble, delay) and the msg3 TB bits must equal JAX's
(and the bits the sent ones); every RRC, NAS, NGAP, PDCP, RLC and GTP-U PDU
of the flow must equal JAX's, byte for byte.  Both receivers run their
plain paths, pinned: JAX's XLA decoder (its CPU frontend is the unfused
one), the port's reference decoder and plain frontend; JAX's PRACH and PUSCH
receivers are compiled as one program each at XLA's optimization level 0.
``os.urandom`` (the RRCSetupRequest's ue_identity) is pinned for both.
"""
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.models import prach as jprach
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu_torch.models import prach as tprach
from openairinterface5g_tpu_torch.models import pusch as tpusch

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TC_RNTI = 0x4601
MSG3 = dict(mu=1, n_prb=6, mcs=4, n_layers=1, n_rx=1, rnti=TC_RNTI)


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _bytes_to_bits(data: bytes, n_bits: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    out = np.zeros(n_bits, np.int8)
    out[: min(len(bits), n_bits)] = bits[:n_bits]
    return out


def _bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(bits.astype(np.uint8)).tobytes()


class _JaxPhy:
    """The JAX package's PRACH and PUSCH, as tests/test_e2e_callflow.py
    calls them (decoder pinned to its XLA path)."""
    pcfg = jprach.PrachConfig()
    ucfg = jpusch.PuschConfig(**MSG3, decoder_backend="xla")

    def prach_tx(self, idx):
        return np.asarray(jprach.prach_tx(self.pcfg, jnp.asarray([idx])))

    def prach_rx(self, rx):
        det = _compiled(lambda r: jprach.prach_rx(self.pcfg, r), jnp.asarray(rx))
        return {k: np.asarray(det[k]) for k in ("detected", "preamble", "delay")}

    def pusch_tx(self, tb):
        return np.asarray(jax.jit(lambda t: jpusch.pusch_tx(self.ucfg, t)[0])(jnp.asarray(tb)))

    def pusch_rx(self, rx):
        out = _compiled(lambda r: jpusch.pusch_rx(self.ucfg, r, n_iters=12), jnp.asarray(rx))
        return np.asarray(out["tb_ok"]), np.asarray(out["tb_bits"])


class _PortPhy:
    """The port's PRACH and PUSCH on the CPU (reference decoder, plain
    frontend)."""
    pcfg = tprach.PrachConfig()
    ucfg = tpusch.PuschConfig(**MSG3, decoder_backend="reference")

    def prach_tx(self, idx):
        return tprach.prach_tx(self.pcfg, torch.tensor([idx])).numpy()

    def prach_rx(self, rx):
        det = tprach.prach_rx(self.pcfg, torch.as_tensor(rx))
        return {k: det[k].numpy() for k in ("detected", "preamble", "delay")}

    def pusch_tx(self, tb):
        return tpusch.pusch_tx(self.ucfg, torch.as_tensor(tb))[0].numpy()

    def pusch_rx(self, rx):
        out = tpusch.pusch_rx(self.ucfg, torch.as_tensor(rx), n_iters=12)
        return out["tb_ok"].numpy(), out["tb_bits"].numpy()


def _mods(root: str):
    names = {"fapi": "fapi.messages", "mac": "l2.mac", "ue_mac": "l2.ue_mac",
             "pdcp": "l2.pdcp", "rlc": "l2.rlc", "nas": "l3.nas", "ngap": "l3.ngap",
             "rrc": "l3.rrc", "gtpu": "l3.gtpu"}
    return types.SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                                    for k, v in names.items()})


def _call_flow(m, phy) -> dict:
    """tests/test_e2e_callflow.py's flow with one package's modules `m` and
    PHY `phy`: its checks, and what the flow detected, decoded and sent."""
    rng = np.random.default_rng(0)
    wire = []

    def tap(tag, fn):
        def send(*args):
            wire.append((tag, *args))
            return fn(*args)
        return send

    # 1. PRACH
    ue_mac = m.ue_mac.UeMac()
    ra_req = ue_mac.start_ra(slot=0, msg3_payload=b"")
    tx_p = phy.prach_tx(ra_req["preamble_index"])
    noise = 0.05 * (rng.normal(size=tx_p.shape) + 1j * rng.normal(size=tx_p.shape))
    det = phy.prach_rx((tx_p + noise.astype(np.complex64))[:, None, :])
    assert bool(det["detected"][0])
    preamble, delay = int(det["preamble"][0]), int(det["delay"][0])
    assert preamble == ra_req["preamble_index"]

    # 2. RACH.indication -> RAR
    gnb_mac = m.mac.MacScheduler(m.mac.SchedulerConfig())
    gnb_mac.on_rach(m.fapi.RachIndication(sfn=0, slot=1, preambles=((preamble, delay, 0),)))
    assert gnb_mac.ra_queue
    msg3 = ue_mac.on_rar(5, {"preamble_index": preamble, "tc_rnti": TC_RNTI, "ul_grant": 64})
    assert msg3 is not None and msg3["rnti"] == TC_RNTI

    # 3. msg3: the RRCSetupRequest inside a PUSCH TB
    ue_rrc, gnb_rrc = m.rrc.UeRrc(), m.rrc.GnbRrc(cell_id=1)
    ul_pdus, dl_pdus = [], []
    ue_rrc.send_ul = tap("rrc ul", lambda srb, pdu: ul_pdus.append(pdu))
    gnb_rrc.send_dl = tap("rrc dl", lambda rnti, srb, pdu: dl_pdus.append(pdu))
    ue_rrc.connect(nas_pdu=b"")
    rrc_pdu = ul_pdus.pop(0)
    ue_mac.msg3_payload = rrc_pdu
    payload = len(rrc_pdu).to_bytes(2, "big") + rrc_pdu
    tb = _bytes_to_bits(payload, phy.ucfg.tbs)[None]
    tx_u = phy.pusch_tx(tb)
    noise_u = 0.02 * (rng.normal(size=(1, 1, tx_u.shape[-1]))
                      + 1j * rng.normal(size=(1, 1, tx_u.shape[-1])))
    tb_ok, tb_bits = phy.pusch_rx(tx_u + noise_u.astype(np.complex64))
    assert bool(tb_ok[0])
    rx_bytes = _bits_to_bytes(tb_bits[0])
    rx_rrc_pdu = rx_bytes[2: 2 + int.from_bytes(rx_bytes[:2], "big")]
    assert m.rrc.decode_ul(rx_rrc_pdu)[0] == "rrcSetupRequest"

    # 4. msg4: RRC setup and contention resolution
    gnb_rrc.handle_ul(TC_RNTI, rx_rrc_pdu)
    assert ue_mac.on_contention_resolution(TC_RNTI, rx_rrc_pdu)
    assert ue_mac.state == "CONNECTED" and ue_mac.c_rnti == TC_RNTI
    ue_rrc.handle_dl(0, dl_pdus.pop(0))
    gnb_rrc.handle_ul(TC_RNTI, ul_pdus.pop(0))
    assert gnb_rrc.ue[TC_RNTI].state == "CONNECTED"

    # 5. NAS registration and the PDU session through NGAP
    ue_nas, amf_nas = m.nas.UeNas(), m.nas.AmfStub()
    dl_nas = []
    gnb_ngap = m.ngap.GnbNgap(nas_downstream=lambda rnti, pdu: dl_nas.append(pdu))
    amf_ngap = m.ngap.AmfNgapStub(nas_handler=amf_nas)
    gnb_ngap.send, amf_ngap.send = tap("ngap ul", amf_ngap.handle), tap("ngap dl", gnb_ngap.handle)
    gnb_ngap.ng_setup()
    ran_id = gnb_ngap.initial_ue_message(TC_RNTI, ue_nas.start())
    for _ in range(10):
        if not dl_nas:
            break
        pdu = dl_nas.pop(0)
        wire.append(("nas dl", pdu))
        for up in ue_nas.handle(pdu):
            wire.append(("nas ul", up))
            gnb_ngap.uplink_nas(ran_id, up)
    assert ue_nas.state == "SESSION" and ue_nas.ip == "10.0.0.2"
    sessions = gnb_ngap.ue[ran_id]["sessions"]
    assert sessions

    # 6. security and a DRB: PDCP (NEA2/NIA2) over RLC UM
    gnb_rrc.start_security(TC_RNTI)
    ue_rrc.handle_dl(1, dl_pdus.pop(0))
    gnb_rrc.handle_ul(TC_RNTI, ul_pdus.pop(0))
    assert gnb_rrc.ue[TC_RNTI].security_on
    key = bytes(range(16))
    got_dl = []
    pdcp_gnb = m.pdcp.PdcpEntity(
        m.pdcp.PdcpConfig(bearer_id=1, ciphering=True, integrity=True, key_enc=key,
                          key_int=key, direction=m.pdcp.DIR_DL), deliver=lambda p: None)
    pdcp_ue = m.pdcp.PdcpEntity(
        m.pdcp.PdcpConfig(bearer_id=1, ciphering=True, integrity=True, key_enc=key,
                          key_int=key, direction=m.pdcp.DIR_UL), deliver=got_dl.append)
    rlc_gnb = m.rlc.RlcUm(deliver=tap("rlc sdu", lambda p: pdcp_ue.pdu_in(p)))
    ip_pkt = b"E\x00\x00\x28" + bytes(36)
    pdcp_pdu = pdcp_gnb.sdu_in(ip_pkt)
    wire.append(("pdcp", pdcp_pdu))
    rlc_gnb.sdu_in(pdcp_pdu)
    while True:
        pdu = rlc_gnb.pdu_out(60)
        if pdu is None:
            break
        wire.append(("rlc", pdu))
        rlc_gnb.pdu_in(pdu)
    assert got_dl == [ip_pkt]

    # 7. GTP-U to the core
    got_upf = []
    upf = m.gtpu.GtpuEndpoint(deliver=lambda sid, p: got_upf.append(p))
    gnb_up = m.gtpu.GtpuEndpoint(transport=tap("gtpu", upf.receive))
    gnb_up.add_session(1, local_teid=0x10, remote_teid=sessions[0]["teid"])
    upf.add_session(1, local_teid=sessions[0]["teid"], remote_teid=0x10)
    gnb_up.send(1, ip_pkt)
    assert got_upf == [ip_pkt]
    return {"prach": (preamble, delay), "tb": tb, "tb_bits": tb_bits, "wire": wire}


@pytest.fixture
def urandom_pinned(monkeypatch):
    """os.urandom as a counter; reset before each package's run."""
    def reset():
        state = {"n": 0}

        def urandom(n):
            state["n"] += 1
            return bytes((state["n"] * 37 + i) & 0xFF for i in range(n))
        monkeypatch.setattr("os.urandom", urandom)
    return reset


def test_call_flow_matches_jax(urandom_pinned):
    urandom_pinned()
    j = _call_flow(_mods("openairinterface5g_tpu"), _JaxPhy())
    urandom_pinned()
    t = _call_flow(_mods("openairinterface5g_tpu_torch"), _PortPhy())
    assert t["prach"] == j["prach"]
    np.testing.assert_array_equal(t["tb_bits"], j["tb_bits"])
    np.testing.assert_array_equal(t["tb_bits"], t["tb"])
    assert [w[0] for w in t["wire"]] == [w[0] for w in j["wire"]]
    assert t["wire"] == j["wire"]
    tags = {w[0] for w in t["wire"]}
    assert {"rrc ul", "rrc dl", "ngap ul", "ngap dl", "nas ul", "nas dl", "pdcp", "rlc",
            "gtpu"} <= tags
