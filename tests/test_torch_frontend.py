"""K3's plain version against the JAX fused frontend and the JAX unfused chain.

On the CPU: the same received grid (made with numpy from a seed) goes
through the Pallas kernel in interpret mode, the JAX chain with
frontend_backend="xla", and the port's frontend_planes_plain.  Tolerance:
2e-4 of max|LLR|, the bar tests/test_pusch_frontend_pallas.py sets between
the kernel and the chain (float32 sums taken in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.ops import pusch_frontend_pallas as jfe
from openairinterface5g_tpu_torch.convert import config_from_jax
from openairinterface5g_tpu_torch.models import pusch as tpusch
from openairinterface5g_tpu_torch.ops import pusch_frontend as tfe

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

TOL = 2e-4

# the six configurations of tests/test_pusch_frontend_pallas.py
CFGS = [
    dict(n_prb=24, mcs=9, n_layers=1, n_rx=1),                  # QPSK MRC
    dict(n_prb=51, mcs=16, n_layers=1, n_rx=2, chest_window=8),  # 16QAM MRC-2
    dict(n_prb=24, mcs=16, n_layers=2, n_rx=2),                  # MMSE 2x2
    dict(n_prb=24, mcs=19, n_layers=2, n_rx=2,
         dmrs_symbols=(2, 11)),                                  # 64QAM 2-DMRS
    dict(n_prb=24, mcs=9, n_layers=2, n_rx=2, dmrs_port0=2),     # delta=1 comb
    dict(n_prb=16, mcs=26, n_layers=1, n_rx=2, chest_window=0),  # 256QAM no-avg
]


def _grid(jcfg, seed=0, B=2):
    """Received RE grid: the port's TX (held to the JAX TX in
    test_torch_pusch.py), a fixed random channel and AWGN."""
    rng = np.random.default_rng(seed)
    tb = torch.as_tensor(rng.integers(0, 2, (B, jcfg.tbs)).astype(np.int8))
    grid_re = tpusch.pusch_tx_grid(config_from_jax(jcfg), tb)[0].numpy()
    h = (rng.standard_normal((jcfg.n_rx, jcfg.n_layers))
         + 1j * rng.standard_normal((jcfg.n_rx, jcfg.n_layers))) / np.sqrt(2)
    y = np.einsum("rl,blsm->brsm", h, grid_re)
    n = rng.standard_normal((2, *y.shape)) * np.sqrt(0.005)
    return (y + n[0] + 1j * n[1]).astype(np.complex64)


def _rel_err(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("kw", CFGS)
def test_plain_frontend_matches_jax(kw):
    jcfg = jpusch.PuschConfig(mu=1, **kw)
    tcfg = config_from_jax(jcfg)
    assert tfe.supported(tcfg) and jfe.supported(jcfg)
    y = _grid(jcfg)
    got = tfe.frontend_planes_plain(tcfg, torch.as_tensor(y)).numpy()
    assert _rel_err(got, jfe.frontend_planes(jcfg, jnp.asarray(y), interpret=True)) < TOL
    # codeword order: the plain planes re-interleaved against the Pallas
    # kernel's, and the port's unfused chain against the JAX chain
    got_cw = tfe.frontend(tcfg, torch.as_tensor(y)).numpy()
    assert _rel_err(got_cw, jfe.frontend(jcfg, jnp.asarray(y), interpret=True)) < TOL
    xcfg = dataclasses.replace(jcfg, frontend_backend="xla")
    ref = jax.jit(lambda g: jpusch.pusch_frontend(xcfg, g))(jnp.asarray(y))
    cw = tpusch.pusch_frontend(dataclasses.replace(tcfg, frontend_backend="reference"),
                               torch.as_tensor(y)).numpy()
    assert _rel_err(cw, ref) < TOL


def test_supported_matches_jax():
    for kw in CFGS + [dict(n_prb=24, mcs=9, n_layers=2, n_rx=2, dmrs_port0=1),
                      dict(n_prb=24, mcs=9, n_layers=3, n_rx=4),
                      dict(n_prb=24, mcs=9, ptrs=True),
                      dict(n_prb=24, mcs=9, chest_mode="delay")]:
        jcfg = jpusch.PuschConfig(mu=1, **kw)
        assert tfe.supported(config_from_jax(jcfg)) == jfe.supported(jcfg), kw


def test_quantized_codeword_llrs():
    jcfg = jpusch.PuschConfig(mu=1, n_prb=24, mcs=16, n_layers=2, n_rx=2, llr_quant_bits=8,
                              frontend_backend="xla")
    y = _grid(jcfg, seed=4)
    ref = np.asarray(jax.jit(lambda g: jpusch.pusch_frontend(jcfg, g))(jnp.asarray(y)))
    got = tpusch.pusch_frontend(config_from_jax(jcfg), torch.as_tensor(y)).numpy()
    assert np.mean(got != ref) < 1e-3          # rounding ties may fall either way
    assert np.max(np.abs(got - ref)) <= 1
