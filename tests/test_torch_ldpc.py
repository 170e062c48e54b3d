"""K1's plain version (ops/ldpc_decoder.decode_plain) against the JAX Pallas
decoder, run in interpret mode on the CPU as tests/test_ldpc_pallas.py does
(compiled by XLA at its CPU optimization level 0).

* check_every=0: the hard bits are identical.  The plain version keeps the
  f32 operation order of ldpc_pallas.py:262-275, so no tolerance is needed.
* check_every=1: the port stops each code block by itself, the Pallas
  kernel 16 at a time; on inputs where JAX reports every block ok, both
  return the transmitted bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openairinterface5g_tpu.coding.ldpc import build_graph
from openairinterface5g_tpu.ops.ldpc_pallas import decode_pallas
from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.coding.backend import decoder
from openairinterface5g_tpu_torch.ops import ldpc_decoder

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _awgn(g, n_cb, seed, snr_db):
    """Random code blocks through BPSK + AWGN; encoded by the port, whose
    encoder test_torch_coding.py holds bit-exact to the JAX one."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (n_cb, g.K)).astype(np.int8)
    cw = tldpc.encode(tldpc.build_graph(g.bg, g.Z), torch.as_tensor(info)).numpy().astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr = 2 * y / sigma ** 2
    llr[:, : 2 * g.Z] = 0
    return info, llr


# BG2 Z=64 takes the Pallas 'col' layout, BG1 Z=384 the 'flat' one with the
# bf16-staged input of the PUSCH receiver
CASES = [(2, 64, 4, np.float32), (1, 384, 3, "bf16")]


def _inputs(bg, Z, n_cb, dtype, snr_db):
    g = build_graph(bg, Z)
    info, llr = _awgn(g, n_cb, seed=Z, snr_db=snr_db)
    if dtype == "bf16":
        return g, info, jnp.asarray(llr).astype(jnp.bfloat16), torch.as_tensor(llr).to(torch.bfloat16)
    return g, info, jnp.asarray(llr), torch.as_tensor(llr)


@pytest.mark.parametrize("bg,Z,n_cb,dtype", CASES)
def test_plain_matches_pallas_bits(bg, Z, n_cb, dtype):
    # low SNR and few iterations: not every block converges, so the
    # comparison covers messages far from a codeword
    g, _, xj, xt = _inputs(bg, Z, n_cb, dtype, snr_db=0.0)
    with pltpu.force_tpu_interpret_mode():
        want_bits, want_ok = _compiled(lambda x: decode_pallas(g, x, n_iters=3), xj)
    got_bits, got_ok = ldpc_decoder.decode_plain(tldpc.build_graph(bg, Z), xt, n_iters=3)
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))


# BG1 Z=384 with bf16 input and check_every=1 is the PUSCH receiver's own
# variant: the 20-PRB slice case of test_torch_pusch.py decodes through it
@pytest.mark.parametrize("bg,Z,n_cb,dtype", CASES[:1])
def test_early_stop_decodes_sent_bits(bg, Z, n_cb, dtype):
    g, info, xj, xt = _inputs(bg, Z, n_cb, dtype, snr_db=3.0)
    with pltpu.force_tpu_interpret_mode():
        want_bits, want_ok = _compiled(
            lambda x: decode_pallas(g, x, n_iters=8, check_every=1), xj)
    assert bool(np.asarray(want_ok).all())
    np.testing.assert_array_equal(np.asarray(want_bits), info)
    # through the registry entry the receiver uses
    got_bits, got_ok = decoder("kernel")(tldpc.build_graph(bg, Z), xt, n_iters=8, check_every=1)
    assert bool(got_ok.all())
    np.testing.assert_array_equal(got_bits.numpy(), info)


def test_plain_early_stop_freezes_converged_blocks():
    """A block that passes its check keeps the decision it passed with."""
    g = tldpc.build_graph(2, 64)
    info, llr = _awgn(build_graph(2, 64), 4, seed=11, snr_db=3.0)
    llr[2] = 0.05 * np.random.default_rng(1).standard_normal(llr.shape[1])  # hopeless block
    bits1, ok1 = ldpc_decoder.decode_plain(g, torch.as_tensor(llr), n_iters=2, check_every=1)
    bits8, ok8 = ldpc_decoder.decode_plain(g, torch.as_tensor(llr), n_iters=8, check_every=1)
    for i in (0, 1, 3):
        assert bool(ok8[i])
        np.testing.assert_array_equal(bits8[i].numpy(), info[i])
        if bool(ok1[i]):
            np.testing.assert_array_equal(bits1[i].numpy(), bits8[i].numpy())
    assert not bool(ok8[2])


def test_cpu_tensor_takes_plain_path():
    g = tldpc.build_graph(2, 64)
    _, llr = _awgn(build_graph(2, 64), 2, seed=5, snr_db=3.0)
    n0 = dict(ldpc_decoder.launches)
    a = ldpc_decoder.decode(g, torch.as_tensor(llr), n_iters=4, check_every=1)
    b = ldpc_decoder.decode_plain(g, torch.as_tensor(llr), n_iters=4, check_every=1)
    assert ldpc_decoder.launches == n0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
