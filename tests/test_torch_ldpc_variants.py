"""K1's flooding and int8-message variants against the Pallas decoder.

The port's plain versions (ops/ldpc_decoder.decode_plain, which ``decode``
runs for CPU tensors and which the CUDA kernel equals on the card) against
decode_pallas run in interpret mode on the CPU, as tests/test_ldpc_pallas.py
runs it.  Same numpy inputs into both; BG2, Z=64, 4 code blocks:

* 0 dB, 8 iterations, the codeword cut to its first 22 of 52 columns (rate
  1/2 after the punctured head), so the decode ends far from a codeword
  (no block converges): hard bits and ok flags are identical, no tolerance.
* 3 dB, 8 iterations, the whole codeword: both give the sent bits, every
  ok flag true.

The int8 variant's quantized input is compared first.  Both cases have the
same shape and iteration count, so each variant's interpret-mode program
is compiled once per module (by XLA at its CPU optimization level 0) and
runs both; each JAX result is computed once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openairinterface5g_tpu.coding.ldpc import build_graph
from openairinterface5g_tpu.ops.ldpc_pallas import decode_pallas
from openairinterface5g_tpu.phy.llr import quantize as jquantize
from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.coding.backend import decoder
from openairinterface5g_tpu_torch.ops import ldpc_decoder

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

BG, Z, N_CB = 2, 64, 4
CASES = {"0dB": (0.0, 8, 22), "3dB": (3.0, 8, None)}   # snr, iterations, columns sent
_JAX_MSG = {torch.float32: jnp.float32, torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}


def awgn(case: str, seed: int = 7):
    """(sent info bits, f32 LLRs) of N_CB random code blocks: BPSK over
    AWGN, punctured head and unsent columns at 0."""
    snr_db, _, n_cols = CASES[case]
    g = tldpc.build_graph(BG, Z)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (N_CB, g.K)).astype(np.int8)
    cw = tldpc.encode(g, torch.as_tensor(info)).numpy().astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr = 2 * y / sigma ** 2
    llr[:, : 2 * Z] = 0
    if n_cols is not None:
        llr[:, n_cols * Z:] = 0
    return info, llr


@functools.lru_cache(maxsize=None)
def _pallas_decoder(schedule: str, msg_dtype: torch.dtype, n_iters: int):
    """decode_pallas of one variant, jitted once: the cases share it."""
    g = build_graph(BG, Z)
    fn = jax.jit(lambda x: decode_pallas(g, x, n_iters=n_iters, schedule=schedule,
                                         msg_dtype=_JAX_MSG[msg_dtype]))
    x = jax.ShapeDtypeStruct((N_CB, g.cols * Z), jnp.float32)
    return fn.lower(x).compile({"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def pallas_result(schedule: str, msg_dtype: torch.dtype, case: str):
    """decode_pallas in interpret mode: (bits, ok) as numpy."""
    _, llr = awgn(case)
    with pltpu.force_tpu_interpret_mode():
        bits, ok = _pallas_decoder(schedule, msg_dtype, CASES[case][1])(jnp.asarray(llr))
    return np.asarray(bits), np.asarray(ok)


def check_against_pallas(schedule: str, msg_dtype: torch.dtype, case: str):
    info, llr = awgn(case)
    want_bits, want_ok = pallas_result(schedule, msg_dtype, case)
    got_bits, got_ok = ldpc_decoder.decode(tldpc.build_graph(BG, Z), torch.as_tensor(llr),
                                           CASES[case][1], schedule=schedule,
                                           msg_dtype=msg_dtype)
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    if case == "3dB":
        assert want_ok.all()
        np.testing.assert_array_equal(want_bits, info)
    return want_ok


VARIANTS = [("flooding", torch.float32), ("layered", torch.int8), ("flooding", torch.int8)]


@pytest.mark.parametrize("schedule,msg_dtype", VARIANTS)
def test_bits_equal_pallas_at_0db(schedule, msg_dtype):
    ok = check_against_pallas(schedule, msg_dtype, "0dB")
    assert not ok.any()          # the comparison covers blocks far from a codeword


@pytest.mark.parametrize("schedule,msg_dtype", VARIANTS)
def test_decodes_sent_bits_at_3db(schedule, msg_dtype):
    check_against_pallas(schedule, msg_dtype, "3dB")


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_quantized_input_equals_jax(case):
    _, llr = awgn(case)
    got = ldpc_decoder.prepare_input(torch.as_tensor(llr), torch.int8)
    want = np.asarray(jquantize(jnp.asarray(llr), bits=8).astype(jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_flooding_bf16_input_is_its_f32_value():
    """f32 messages take bf16 input as given: the same decode as its exact
    f32 widening."""
    _, llr = awgn("0dB")
    g = tldpc.build_graph(BG, Z)
    x = torch.as_tensor(llr).to(torch.bfloat16)
    a = ldpc_decoder.decode(g, x, 3, schedule="flooding")
    b = ldpc_decoder.decode(g, x.float(), 3, schedule="flooding")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_registry_passes_schedule():
    """The "kernel" registry entry takes schedule, as the JAX "pallas" one does."""
    _, llr = awgn("0dB")
    g = tldpc.build_graph(BG, Z)
    x = torch.as_tensor(llr)
    got = decoder("kernel")(g, x, n_iters=3, schedule="flooding", sb=8)
    want = ldpc_decoder.decode_plain(g, x, 3, schedule="flooding")
    layered = ldpc_decoder.decode_plain(g, x, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(want[0], layered[0])


@pytest.mark.parametrize("schedule,msg_dtype", VARIANTS)
def test_early_stop_keeps_converged_decisions(schedule, msg_dtype):
    """With check_every=1 a block stops at its first passing check and
    reports the iterations it ran; at 3 dB every block decodes."""
    info, llr = awgn("3dB")
    g = tldpc.build_graph(BG, Z)
    bits, ok, iters = ldpc_decoder.decode_plain(g, torch.as_tensor(llr), 8, check_every=1,
                                                schedule=schedule, msg_dtype=msg_dtype,
                                                return_iters=True)
    assert bool(ok.all()) and np.array_equal(bits.numpy(), info)
    assert iters.dtype == torch.int32 and 1 <= int(iters.min()) and int(iters.max()) < 8


def test_bad_variant_raises():
    g = tldpc.build_graph(BG, Z)
    x = torch.zeros((1, g.cols * Z))
    with pytest.raises(ValueError):
        ldpc_decoder.decode(g, x, schedule="zigzag")
    with pytest.raises(ValueError):
        ldpc_decoder.decode(g, x, msg_dtype=torch.float16)
