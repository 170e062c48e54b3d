// K1, flooding schedule: normalized min-sum LDPC decoder for NR base graphs
// 1 and 2 (TS 38.212 §5.3.2), with a per-code-block early stop.
//
// Replaces the Pallas kernel openairinterface5g_tpu/ops/ldpc_pallas.py::
// _build_decoder in the flooding variants decode_pallas reaches it with
// (the row-layered ones and K2 are csrc/ldpc_layered.cu):
//   messages  f32 (f32 totals), int8 (int32 arithmetic, ±127 saturation,
//             alpha = 13/16 in integers), or bf16 (bf16 totals);
//   input     f32 or bf16 LLRs (f32 messages), bf16 (bf16 messages),
//             int32 pre-quantized LLRs in [-127, 127] (int8 messages);
//   early stop  syndrome check every `check_every` iterations.
//
// Arithmetic (csrc/ldpc_arith.cuh).  Per row r and check node k, for each
// edge (c, s) of r:
//   v = total[c][(k + s) % Z] - c2v_old,
//   m1/m2/sign over the row's |v|,  c2v_new = ±scale(|v| == m1 ? m2 : m1),
// with the totals fixed for the whole iteration; then
//   total[c] = llr[c] + every c2v_new of column c, added in ascending row
//   order (ldpc_pallas.py:240-245).
// So the hard bits, flags and iteration counts equal the plain PyTorch
// version's (ops/ldpc_decoder.py::decode_plain) and the Pallas kernel's
// bit for bit.
//
// What bounds it on an H100.  Not bytes: the LLRs are read once and the
// bits written once.  Flooding's variable-node pass needs every message of
// a column, and one BG1 code block at Z = 384 has 316 x 384 of them (474
// KiB in f32), more than a block's 227 KB of shared memory; kept in a
// (B, E, Z) device-memory scratch they would take 101 MB at 208 code
// blocks, twice the 50 MB L2, written once and read twice an iteration.
// Without them the time is that of a chain of dependent layers, as for the
// layered kernel.
//
// Design (csrc/ldpc_min_sum.cuh): no messages at all.  Per (row, lane) the
// compressed check-node state of the layered kernel (12 B in f32 and int8,
// 8 B in bf16) gives back each old message; the new messages are added,
// layer by layer with a barrier between layers, into a second (cols, Z)
// totals buffer that starts from the LLRs, which keeps the reference's
// order of addition; the buffers swap after each iteration.  One thread
// block per code block, Z threads.  The two buffers take 2 x 104 KB at BG1
// Z=384 in f32 and int32 (int8 messages), so one block per SM (208 code
// blocks in two waves over 132 SMs); bf16 totals are bf16, 2 x 52 KB, two
// blocks per SM.  The LLRs are read again from L2 into the new buffer each
// iteration.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "ldpc_min_sum.cuh"

namespace {

using namespace oai5g;

// blocks per SM the registers must allow: as many as the shared memory
// holds at BG1 Z=384
template <int M>
constexpr int kFloodBlocks = sizeof(typename Arith<M>::tot) == 4 ? 1 : 2;

template <int M, typename T>
__global__ void __launch_bounds__(kMaxZ, kFloodBlocks<M>)
ldpc_flooding_kernel(const DecodeArgs p) {
  decode_block<M, T, true>(p);
}

template <int M, typename T> struct Flooding {
  static int launch(const DecodeArgs& p, int B, int device, cudaStream_t s) {
    return launch_decode<M, T, true>(ldpc_flooding_kernel<M, T>, p, B, device, s);
  }
};

}  // namespace

// llr (B, cols*Z) -> bits (B, K) int8, ok (B,) bool and, where `iters` is
// not null, the iterations each code block ran (B,) int32, under the
// flooding schedule.  in_kind: 0 f32, 1 bf16, 2 int32; msg_kind: 0 f32,
// 1 int8, 2 bf16 (the pairs decode_pallas forms: f32 messages with f32 or
// bf16 input, int8 with int32 input in [-127, 127], bf16 with bf16 input).
// For bf16 messages `alpha` must already be rounded to bf16.  state and
// tables as for ldpc_layered_decode (csrc/ldpc_layered.cu).  All tensors
// on CUDA device `device`.
extern "C" int ldpc_flooding_decode(const void* llr, int in_kind, int msg_kind, void* bits,
                                    void* ok, void* iters, void* state, const void* tables,
                                    int B, int layers, int rows, int cols, int E, int Z, int K,
                                    int n_iters, int check_every, float alpha, int device,
                                    void* stream) {
  if (B == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return decode_entry<true, Flooding>(llr, in_kind, msg_kind, bits, ok, iters, state,
                                     tables, B, layers, rows, cols, E, Z, K, n_iters,
                                     check_every, alpha, device, stream);
}
