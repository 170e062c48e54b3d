// K1, row-layered schedule, and K2: normalized min-sum LDPC decoders for NR
// base graphs 1 and 2 (TS 38.212 §5.3.2).
//
// Replaces two Pallas kernels of openairinterface5g_tpu/ops/ldpc_pallas.py
// in the layered variants decode_pallas reaches them with:
//   * _build_decoder (K1): f32 messages (f32 totals) with f32 or bf16
//     input, and int8 messages (int32 arithmetic, ±127 saturation, alpha =
//     13/16 in integers) with int32 pre-quantized input; early stop every
//     `check_every` iterations;
//   * _build_decoder_bf16 (K2): bf16 messages and totals with bf16 input
//     clipped to ±24 (by the wrapper), every operation computed in f32 and
//     rounded to bf16; the sign of a value is its sign BIT, so -0.0 counts
//     as negative in the check-node sign and in the parity flag, while the
//     hard bit is soft < 0; no early stop (the Pallas kernel takes
//     `check_every` and never reads it).
// (The flooding variants of K1 are csrc/ldpc_flooding.cu.)
//
// Arithmetic (csrc/ldpc_arith.cuh), per row r and check node k, for each
// edge d = (c, s) of r, in the order of ldpc_pallas.py:225-275 (K2:
// :427-489):
//   v_d = total[c][(k + s) % Z] - c2v_old_d,
//   m1/m2 over the row's |v|, neg = XOR of the row's signs,
//   c2v_new_d = sat(±scale(|v_d| == m1 ? m2 : m1)), sign neg ^ sign(v_d),
//   total[c][(k + s) % Z] = t + (c2v_new_d - c2v_old_d).
// So the hard bits and flags equal the plain PyTorch versions'
// (ops/ldpc_decoder.py::decode_plain, decode_bf16_plain) and the Pallas
// kernels' bit for bit.  K2's messages are ±mag with the sign bit set or
// not, magnitudes >= +0.0, so the compressed state gives them back exactly,
// -0.0 included.
//
// What bounds it on an H100.  Not bytes: the LLRs are read once and the
// bits written once.  A layered decode is a chain of dependent layers, each
// ending in a block-wide barrier, so the time is the layers' latency and
// the issue of their operations on the SM.  One BG1 code block at Z = 384
// would have 316 x 384 f32 messages (474 KiB), more than the 227 KB of
// shared memory beside its 104 KB of totals; kept as messages in device
// memory they would be 101 MB at 208 code blocks (twice the 50 MB L2).
//
// Design (csrc/ldpc_min_sum.cuh): compressed check-node state instead of
// messages, layers of orthogonal rows with one barrier each, the next
// layer's state loaded before the barrier, the graph in shared memory, rows
// unrolled to their exact degree, the packed syndrome check where Z % 32 ==
// 0.  One thread block per code block, Z threads; the totals in dynamic
// shared memory (f32 and int8 104 KB at BG1 Z=384, K2's bf16 52 KB), two
// blocks per SM, so 208 code blocks are resident at once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "ldpc_min_sum.cuh"

namespace {

using namespace oai5g;

template <int M, typename T>
__global__ void __launch_bounds__(kMaxZ, 2) ldpc_layered_kernel(const DecodeArgs p) {
  decode_block<M, T, false>(p);
}

template <int M, typename T> struct Layered {
  static int launch(const DecodeArgs& p, int B, int device, cudaStream_t s) {
    return launch_decode<M, T, false>(ldpc_layered_kernel<M, T>, p, B, device, s);
  }
};

}  // namespace

// llr (B, cols*Z) -> bits (B, K) int8, ok (B,) bool and, where `iters` is
// not null, the iterations each code block ran (B,) int32, under the
// row-layered schedule.  in_kind: 0 f32, 1 bf16, 2 int32; msg_kind: 0 f32
// (f32 or bf16 input), 1 int8 (int32 input in [-127, 127]), 3 K2 (bf16
// input clipped to ±24; check_every is ignored, every code block runs
// n_iters iterations).  For bf16 input to K2 `alpha` must already be
// rounded to bf16.
// state: scratch never read before the kernel writes it, 8-byte aligned:
// B * rows * Z magnitude pairs (f32, int8: 8 B; K2: 4 B), then B * rows * Z
// words of 4 B.  tables: int32, `layers` words (first row | rows << 16),
// then `rows` words (first edge | degree << 16), then E words (col * Z |
// shift << 16), rows in order and each row's edges in column order; every
// row's degree 3 to 10 or 19, as in the NR base graphs; at most 3 rows a
// layer, of which no two share a column.  All tensors on CUDA device
// `device`.
extern "C" int ldpc_layered_decode(const void* llr, int in_kind, int msg_kind, void* bits,
                                   void* ok, void* iters, void* state, const void* tables,
                                   int B, int layers, int rows, int cols, int E, int Z, int K,
                                   int n_iters, int check_every, float alpha, int device,
                                   void* stream) {
  if (B == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return decode_entry<false, Layered>(llr, in_kind, msg_kind, bits, ok, iters, state,
                                      tables, B, layers, rows, cols, E, Z, K, n_iters,
                                      check_every, alpha, device, stream);
}
