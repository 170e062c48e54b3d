"""K1's bf16 flooding variant and K2 (bf16 layered) against the Pallas decoder.

The port's plain versions (ops/ldpc_decoder.decode_plain and
decode_bf16_plain, which the CUDA kernels equal on the card) against
decode_pallas with msg_dtype=bfloat16, run in interpret mode on the CPU.
Same numpy inputs, same cases as tests/test_torch_ldpc_variants.py (one
interpret-mode program per variant runs both): at 0 dB after 8 iterations
on a rate-1/2 cut, hard bits and ok flags are identical (every bf16
operation rounds in the same place: computed in f32, rounded to bf16, in
XLA and in PyTorch alike); at 3 dB after 8 iterations both give the sent
bits.
"""
import numpy as np
import pytest
import torch

from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.ops import ldpc_decoder
from test_torch_ldpc_variants import BG, Z, awgn, check_against_pallas

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

VARIANTS = [("flooding", torch.bfloat16), ("layered", torch.bfloat16)]


@pytest.mark.parametrize("schedule,msg_dtype", VARIANTS)
def test_bits_equal_pallas_at_0db(schedule, msg_dtype):
    ok = check_against_pallas(schedule, msg_dtype, "0dB")
    assert not ok.any()


@pytest.mark.parametrize("schedule,msg_dtype", VARIANTS)
def test_decodes_sent_bits_at_3db(schedule, msg_dtype):
    check_against_pallas(schedule, msg_dtype, "3dB")


def test_bf16_input_is_clipped():
    """bf16 messages take the LLRs clipped to +-24, then rounded to bf16."""
    x = torch.tensor([[-100.0, -24.0, -1.00390625, 0.0, 3.14159, 30.0]])
    got = ldpc_decoder.prepare_input(x, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.tensor([[-24.0, -24.0, -1.0, 0.0, 3.140625, 24.0]])
    assert torch.equal(got.float(), want)


def test_k2_ignores_check_every():
    """K2 runs n_iters iterations whatever check_every says, as the Pallas
    kernel does (it takes the argument and never reads it)."""
    _, llr = awgn("3dB")
    g = tldpc.build_graph(BG, Z)
    x = torch.as_tensor(llr)
    a = ldpc_decoder.decode(g, x, 8, msg_dtype=torch.bfloat16, check_every=1)
    b = ldpc_decoder.decode(g, x, 8, msg_dtype=torch.bfloat16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _, _, iters = ldpc_decoder.decode_plain(g, x, 8, check_every=1, msg_dtype=torch.bfloat16,
                                            return_iters=True)
    assert (iters == 8).all()


def test_k2_sign_bit_of_negative_zero():
    """K2 takes signs from the sign bit: a total of -0.0 is bit 0 but
    counts as 1 in the parity flag, as in ldpc_pallas.py:484-489."""
    g = tldpc.build_graph(BG, Z)
    x = torch.zeros((1, g.cols * Z), dtype=torch.bfloat16)
    bits, ok = ldpc_decoder.decode_bf16_plain(g, x, n_iters=0)
    assert not bits.any() and bool(ok.all())            # +0.0 everywhere: codeword 0
    x[0, 5 * Z + 3] = -0.0
    bits, ok = ldpc_decoder.decode_bf16_plain(g, x, n_iters=0)
    assert not bits.any() and not bool(ok.any())        # same bits, flag fails
    np.testing.assert_array_equal(
        ldpc_decoder.decode_plain(g, x.float(), 0)[1].numpy(), [True])   # K1: sign by < 0
