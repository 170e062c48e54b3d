"""The port's LTE stack above the PHY (l3/per.py, lte/mac.py, lte/rrc.py)
and its lte-softmodem loop (runtime/lte_softmodem.py,
sim/lte_softmodem_sim.py) against the JAX package's, on the CPU; cases after
tests/test_lte_stack.py.

per.py, mac.py and rrc.py are copies: their code equals the originals'
(docstrings aside), their PDUs and grants equal JAX's.  The loop's AWGN
comes from a torch.Generator, so its lines are held to LTE_LOOP_r5.txt
(the JAX loop's record) where they do not depend on the noise: the RRC line
and cycles 0-3, whose MCS follows only the ACKs and the initial CQI of 10.
JAX's loop is not run again here: tests/test_lte_stack.py runs it.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from openairinterface5g_tpu.l3 import per as jper
from openairinterface5g_tpu.lte import mac as jmac
from openairinterface5g_tpu.lte import rrc as jrrc
from openairinterface5g_tpu_torch.l3 import per as tper
from openairinterface5g_tpu_torch.lte import mac as tmac
from openairinterface5g_tpu_torch.lte import rrc as trrc
from openairinterface5g_tpu_torch.runtime import lte_softmodem
from openairinterface5g_tpu_torch.sim import lte_softmodem_sim

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _code(path: pathlib.Path) -> str:
    """The module's AST without its docstring."""
    tree = ast.parse(path.read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["l3/per.py", "lte/mac.py", "lte/rrc.py"])
def test_copies_equal_originals(rel):
    assert _code(ROOT / "openairinterface5g_tpu_torch" / rel) == \
        _code(ROOT / "openairinterface5g_tpu" / rel)


# one value of every field of every message of lte/rrc.py
_MESSAGES = (
    ("rrcConnectionRequest", {"ue_identity": 0x5A5, "establishment_cause": "mo-Data"}),
    ("rrcConnectionSetup", {"rrc_transaction_id": 0, "radio_resource_config": b"srb1+mac+phy"}),
    ("rrcConnectionSetupComplete", {"rrc_transaction_id": 1, "selected_plmn": 6,
                                    "dedicated_info_nas": b"ATTACH_REQ"}),
    ("securityModeCommand", {"rrc_transaction_id": 2, "ciphering_algorithm": "eea2",
                             "integrity_algorithm": "eia3"}),
    ("securityModeComplete", {"rrc_transaction_id": 2}),
    ("rrcConnectionReconfiguration", {"rrc_transaction_id": 3, "drb_to_add": 1,
                                      "eps_bearer_id": 5}),
    ("rrcConnectionReconfiguration", {"rrc_transaction_id": 3, "drb_to_add": 32,
                                      "eps_bearer_id": 15, "meas_config": b"\x00\xff"}),
    ("rrcConnectionReconfigurationComplete", {"rrc_transaction_id": 3}),
    ("rrcConnectionRelease", {"rrc_transaction_id": 0, "release_cause": "rrc-Suspend"}),
)


@pytest.mark.parametrize("name,fields", _MESSAGES, ids=[m[0] for m in _MESSAGES])
def test_rrc_pdus_match_jax(name, fields):
    """The port's per.py encodes every RRC message to JAX's bytes, and both
    decode them back."""
    pdu = trrc.encode_msg(name, fields)
    assert pdu == jrrc.encode_msg(name, fields)
    assert tper.encode(trrc.MSG, (name, fields)) == jper.encode(jrrc.MSG, (name, fields))
    assert trrc.decode_msg(pdu) == jrrc.decode_msg(pdu)
    got_name, got = trrc.decode_msg(pdu)
    assert got_name == name and all(got[k] == v for k, v in fields.items())


def _connect(rrc_mod):
    """Drive EnbRrc and LteUeRrc to ACTIVE, then release: (every PDU in
    order, both states)."""
    dl_q, ul_q, log = [], [], []
    enb = rrc_mod.EnbRrc(send=lambda rnti, pdu: (dl_q.append(pdu), log.append(pdu)))
    ue = rrc_mod.LteUeRrc(send=lambda pdu: (ul_q.append(pdu), log.append(pdu)))
    ue.connect()
    enb.on_ccch(0x4444, ul_q.pop(0))
    while dl_q or ul_q:
        if dl_q:
            ue.on_dl(dl_q.pop(0))
        if ul_q:
            enb.on_dcch(0x4444, ul_q.pop(0))
    states = (enb.ues[0x4444].state, ue.state, ue.drbs)
    enb.release(0x4444)
    ue.on_dl(dl_q.pop(0))
    return log, states + (ue.state,)


def test_rrc_connection_matches_jax():
    got, want = _connect(trrc), _connect(jrrc)
    assert got == want
    assert got[1] == ("ACTIVE", "ACTIVE", (1,), "IDLE") and len(got[0]) == 8


def test_scheduler_matches_jax():
    """EnbScheduler's grants over a seeded sequence of ACKs, CRCs and CQIs
    equal JAX's, and so do the DCI payloads."""
    rng = np.random.default_rng(7)
    t = tmac.EnbScheduler(tmac.EnbSchedulerConfig(n_rb=25))
    j = jmac.EnbScheduler(jmac.EnbSchedulerConfig(n_rb=25))
    for s in (t, j):
        s.add_ue(0x77, cqi=10)
    for step in range(200):
        sf = int(rng.integers(0, 10))
        ack, crc, cqi = bool(rng.random() < 0.7), bool(rng.random() < 0.8), int(rng.integers(0, 16))
        gd, gu = t.schedule_dl(0x77), t.schedule_ul(0x77, sf)
        assert (gd, gu) == (j.schedule_dl(0x77), j.schedule_ul(0x77, sf)), step
        np.testing.assert_array_equal(tmac.pack_dci(**gd), jmac.pack_dci(**gd))
        assert tmac.unpack_dci(tmac.pack_dci(**gu)) == gu
        for s in (t, j):
            s.on_dl_ack(0x77, gd["harq_id"], ack)
            s.on_ulsch_crc(0x77, sf, crc)
            if step % 4 == 0:
                s.on_cqi(0x77, cqi)
    assert tmac.DCI_A == jmac.DCI_A
    assert [tmac.cqi_to_mcs(c, o) for c in range(16) for o in (-6, 0, 2)] == \
        [jmac.cqi_to_mcs(c, o) for c in range(16) for o in (-6, 0, 2)]


def test_lte_softmodem_loop_cpu():
    """run_loop(4) on the CPU: the RRC line and cycles 0-3 equal
    LTE_LOOP_r5.txt's lines 10-14, 7 signalling TBs, 4/4 ACKed and OK."""
    lines = []
    st = lte_softmodem.run_loop(4, log=lines.append, device="cpu")
    record = (ROOT / "LTE_LOOP_r5.txt").read_text().splitlines()
    assert lines[:5] == record[9:14]
    assert st["rrc_msgs"] == 7
    assert (st["dl_ack"], st["dl_tx"], st["ul_ok"], st["ul_rx"]) == (4, 4, 4, 4)
    assert st["dl_retx"] == st["ul_retx"] == 0 and st["subframes"] == 16


def test_lte_softmodem_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lte_softmodem_sim.main(["--cycles", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        lte_softmodem.run_loop(1)
