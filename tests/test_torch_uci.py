"""UCI on PUSCH in the port against the JAX package, on the CPU.

HARQ-ACK, CSI part 1 and CSI part 2 multiplexed into a 2-layer PUSCH (8 PRB,
MCS 16, 2 RX) in two configurations: 6 ACK bits rate-matched (small block),
16 CSI-1 bits (polar with PC bits and CRC6) and 40 CSI-2 bits (polar with
CRC11); and 2 ACK bits, which puncture the data and CSI part 2.

Tolerances: the RE selection, the G sizes and the scrambled codeword bits
equal; the TX samples within 1e-5 of their largest magnitude (float32 FFTs
of two libraries); the receivers' codeword LLRs (the data after the demux)
within 1e-4 of their largest magnitude; tb_ok, tb_bits, ack_bits and every
UCI stream's bits and ok flag equal.  JAX runs its XLA path (frontend and
decoder "xla" pinned: its CPU default would switch paths on its own), the
port its reference path; JAX's TX and RX are each compiled as one program
by XLA at its CPU optimization level 0 (eagerly they compile op by op,
about three times as long).
With the fused frontend (JAX "pallas" in interpret mode, the port "kernel",
its plain version on the CPU) the LLRs agree within K3's bar, 2e-4 of their
largest magnitude, and the decode is equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.models import uci_on_pusch as juci
from openairinterface5g_tpu_torch.convert import config_from_jax
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.models import uci_on_pusch as tuci
from openairinterface5g_tpu_torch.ops import pusch_frontend as tfe

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

JCFG = jpusch.PuschConfig(mu=1, n_prb=8, mcs=16, n_layers=2, n_rx=2, frontend_backend="xla",
                          decoder_backend="xla")
UCIS = [dict(n_ack_bits=6, n_csi1_bits=16, n_csi2_bits=40),
        dict(n_ack_bits=2, n_csi1_bits=16, n_csi2_bits=40)]
B = 3


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


@pytest.mark.parametrize("kw", UCIS + [dict(n_ack_bits=2, n_csi1_bits=6, n_csi2_bits=32),
                                       dict(n_ack_bits=11, n_csi1_bits=0, n_csi2_bits=0)])
def test_uci_maps_match_jax(kw):
    for jcfg in (JCFG, jpusch.PuschConfig(mu=1, n_prb=8, mcs=9)):
        tcfg = config_from_jax(jcfg)
        ju, tu = juci.UciOnPuschConfig(**kw), tuci.UciOnPuschConfig(**kw)
        assert tu.g_sizes(tcfg) == ju.g_sizes(jcfg)
        for got, want in zip(tuci._build_map(tcfg, tu), juci._build_map(jcfg, ju)):
            np.testing.assert_array_equal(got, want)


def _rx(kw, tb, rng):
    """JCFG's UCI TX through a 2x2 channel at 12 dB, as numpy samples; the
    payloads come first from rng."""
    ack, c1, c2 = (rng.integers(0, 2, (B, n)).astype(np.int8) for n in kw.values())
    jtx, jscr = _compiled(lambda t, a, b, c: jpusch.pusch_tx(
        JCFG, t, uci_cfg=juci.UciOnPuschConfig(**kw), ack_bits=a, csi1_bits=b, csi2_bits=c),
        jnp.asarray(tb), jnp.asarray(ack), jnp.asarray(c1), jnp.asarray(c2))
    jtx = np.asarray(jtx)
    H = (np.eye(2) + 0.3 * (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))))
    rx = np.einsum("rl,bls->brs", H, jtx)
    sig = np.mean(np.abs(rx) ** 2)
    n = rng.standard_normal((2, *rx.shape))
    rx = (rx + np.sqrt(sig * 10 ** (-12 / 10) / 2) * (n[0] + 1j * n[1])).astype(np.complex64)
    return (ack, c1, c2), jtx, jscr, rx


def _same_decode(tout, jout, tb, sent):
    """tb_ok, tb_bits, ack_bits and every UCI stream equal between the two
    receivers, and equal to what was sent."""
    for k in ("tb_ok", "tb_bits", "ack_bits"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert sorted(tout["uci"]) == sorted(jout["uci"])
    for k in tout["uci"]:
        np.testing.assert_array_equal(tout["uci"][k].numpy(), np.asarray(jout["uci"][k]),
                                      err_msg=k)
    assert bool(tout["tb_ok"].all()) and torch.equal(tout["tb_bits"], torch.as_tensor(tb))
    for name, bits in zip(("ack", "csi1", "csi2"), sent):
        assert bool(tout["uci"][name + "_ok"].all())
        np.testing.assert_array_equal(tout["uci"][name].numpy(), bits)


@pytest.mark.parametrize("kw", UCIS)
def test_uci_on_pusch_matches_jax(kw):
    tcfg = config_from_jax(JCFG)
    assert tcfg.decoder_backend == "reference" and tcfg.frontend_backend == "reference"
    ju, tu = juci.UciOnPuschConfig(**kw), tuci.UciOnPuschConfig(**kw)
    rng = np.random.default_rng(sum(kw.values()))
    tb = rng.integers(0, 2, (B, JCFG.tbs)).astype(np.int8)
    sent, jtx, jscr, rx = _rx(kw, tb, rng)
    ttx, tscr = tpusch.pusch_tx(tcfg, torch.as_tensor(tb), uci_cfg=tu,
                                **{f"{k}_bits": torch.as_tensor(v)
                                   for k, v in zip(("ack", "csi1", "csi2"), sent)})
    np.testing.assert_array_equal(tscr.numpy(), np.asarray(jscr))
    assert np.abs(ttx.numpy() - jtx).max() <= 1e-5 * np.abs(jtx).max()
    jout = _compiled(lambda r: jpusch.pusch_rx(JCFG, r, n_iters=8, uci_cfg=ju), jnp.asarray(rx))
    tout = tpusch.pusch_rx(tcfg, torch.as_tensor(rx), n_iters=8, uci_cfg=tu)
    jl = np.asarray(jout["llrs"])
    assert np.abs(tout["llrs"].numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
    _same_decode(tout, jout, tb, sent)


def test_uci_takes_the_fused_frontend(monkeypatch):
    """With uci_cfg and a frontend the fused kernel computes, the receiver
    cuts the UCI streams from the fused frontend's codeword-order LLRs
    (fe.frontend; its plain version on the CPU), as JAX with
    frontend_backend="pallas" does; without uci_cfg it takes the planes.
    LLRs within K3's bar, 2e-4 of max|LLR| (tests/test_torch_frontend.py),
    of JAX's Pallas kernel in interpret mode and of the port's reference
    chain; the decode, at the default 20 iterations, equal to both."""
    kw = UCIS[0]
    rng = np.random.default_rng(7)
    tb = rng.integers(0, 2, (B, JCFG.tbs)).astype(np.int8)
    sent, _, _, rx = _rx(kw, tb, rng)
    calls = []
    for name in ("frontend", "frontend_planes"):
        real = getattr(tfe, name)
        monkeypatch.setattr(tfe, name, lambda c, g, real=real, name=name:
                            calls.append(name) or real(c, g))
    tu = tuci.UciOnPuschConfig(**kw)
    kcfg = dataclasses.replace(config_from_jax(JCFG), frontend_backend="kernel")
    tout = tpusch.pusch_rx(kcfg, torch.as_tensor(rx), uci_cfg=tu)
    assert calls == ["frontend", "frontend_planes"]
    jcfg = dataclasses.replace(JCFG, frontend_backend="pallas")
    jout = _compiled(lambda r: jpusch.pusch_rx(jcfg, r, uci_cfg=juci.UciOnPuschConfig(**kw)),
                     jnp.asarray(rx))
    rout = tpusch.pusch_rx(config_from_jax(JCFG), torch.as_tensor(rx), uci_cfg=tu)
    for ref in (np.asarray(jout["llrs"]), rout["llrs"].numpy()):
        assert np.abs(tout["llrs"].numpy() - ref).max() <= 2e-4 * np.abs(ref).max()
    _same_decode(tout, jout, tb, sent)
    _same_decode(tout, rout, tb, sent)
    calls.clear()
    out = tpusch.pusch_rx(kcfg, torch.as_tensor(rx))
    assert calls == ["frontend_planes"] and out["ack_bits"] is None and out["uci"] is None


def test_uci_with_the_re_map_raises():
    """The JAX model asserts UCI is not combined with the RE map; the port
    raises ValueError there, at the TX and the RX."""
    cfg = tpusch.PuschConfig(mu=1, n_prb=6, mcs=4, ptrs=True)
    u = tuci.UciOnPuschConfig()
    with pytest.raises(ValueError, match="RE map"):
        tpusch.pusch_tx_grid(cfg, torch.zeros((1, cfg.tbs), dtype=torch.int8), uci_cfg=u,
                             ack_bits=torch.zeros((1, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="RE map"):
        tpusch.pusch_rx_grid(cfg, torch.zeros((1, 1, 14, cfg.fp.n_sc), dtype=torch.complex64),
                             uci_cfg=u)
