// K1, flooding schedule: normalized min-sum LDPC decoder for NR base graphs
// 1 and 2 (TS 38.212 §5.3.2), with a per-code-block early stop.
//
// Replaces the Pallas kernel openairinterface5g_tpu/ops/ldpc_pallas.py::
// _build_decoder in the flooding variants decode_pallas reaches it with
// (the row-layered ones are csrc/ldpc_layered.cu):
//   messages  f32 (f32 totals), int8 (int32 totals, ±127 saturation,
//             alpha = 13/16 in integers), or bf16 (bf16 totals);
//   input     f32 or bf16 LLRs (f32 messages), bf16 (bf16 messages),
//             int32 pre-quantized LLRs (int8 messages);
//   early stop  syndrome check every `check_every` iterations.
//
// Arithmetic (csrc/ldpc_arith.cuh).  Per row r and check node k, for each
// edge (c, s) of r:
//   v = total[c][(k + s) % Z] - c2v_old,
//   m1/m2/sign over the row's |v|,  c2v_new = ±scale(|v| == m1 ? m2 : m1),
// with the totals fixed for the whole check-node pass; then
//   total[c] = llr[c] + every c2v message of column c, added in edge order
//   (row-major, ldpc_pallas.py:240-245).
// So the hard bits equal the plain PyTorch version's and the Pallas
// kernel's bit for bit.
//
// What bounds it on an H100.  One BG1 code block at Z = 384 has 316 x 384
// check-to-variable messages (474 KiB in f32), more than the 227 KB of
// shared memory a block may use beside the column totals and the LLRs
// (2 x 68 x 384 x 4 B), and flooding's variable-node pass needs every
// message, so they stay in a (B, E, Z) device-memory scratch: every
// iteration writes each message once and reads it twice.
//
// Design.  One thread block per code block, Z threads.  In the check-node
// pass thread k is check node k of every row; in the variable-node pass
// thread j is variable j of every column, walking a per-column edge list
// built on the host.  The totals and the LLRs live in dynamic shared
// memory as 32-bit values; the messages are read and written by
// consecutive threads at consecutive addresses.  Two __syncthreads() per
// iteration.  The early stop is per code block: after every
// `check_every`-th iteration a block-wide syndrome check
// (__syncthreads_or) ends that block's decode alone, where the TPU stopped
// `sb` blocks together.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "ldpc_arith.cuh"

namespace {

using namespace oai5g;

constexpr int kMaxDeg = 19;      // largest check-node degree of BG1 (BG2: 10)
constexpr int kMaxZ = 384;       // largest lifting size: one thread per lane

// 1 in every thread if any parity check of the code block fails.
template <typename Acc>
__device__ int any_check_fails(const Acc* tot, const int* __restrict__ row_ptr,
                               const int* __restrict__ ecol,
                               const int* __restrict__ eshift, int rows, int k,
                               int Z) {
  int bad = 0;
  for (int r = 0; r < rows; ++r) {
    int par = 0;
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      int idx = k + eshift[e];
      if (idx >= Z) idx -= Z;
      par ^= tot[ecol[e] * Z + idx] < 0;
    }
    bad |= par;
  }
  return __syncthreads_or(bad);
}

template <int M, typename T>
__global__ void __launch_bounds__(kMaxZ)
ldpc_flooding_kernel(const T* __restrict__ llr, int8_t* __restrict__ bits,
                     uint8_t* __restrict__ ok, typename Arith<M>::msg* __restrict__ c2v,
                     const int* __restrict__ row_ptr, const int* __restrict__ ecol,
                     const int* __restrict__ eshift, const int* __restrict__ col_ptr,
                     const int* __restrict__ col_edge, int rows, int cols, int E, int Z,
                     int K, int n_iters, int check_every, float alpha) {
  using A = Arith<M>;
  using Acc = typename A::acc;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* tot = reinterpret_cast<Acc*>(smem);        // (cols, Z) natural orientation
  Acc* lsm = tot + cols * Z;                       // (cols, Z) LLRs
  const int b = blockIdx.x;
  const int k = threadIdx.x;                       // blockDim.x == Z
  const T* llr_b = llr + (size_t)b * cols * Z;
  typename A::msg* msg = c2v + (size_t)b * E * Z;

  for (int i = k; i < cols * Z; i += Z) {
    const Acc x = load_llr(llr_b, i);
    tot[i] = x;
    lsm[i] = x;
  }
  for (int e = 0; e < E; ++e) msg[(size_t)e * Z + k] = A::store(0);
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // check-node pass: totals fixed
    for (int r = 0; r < rows; ++r) {
      const int e0 = row_ptr[r];
      const int deg = row_ptr[r + 1] - e0;
      Acc t[kMaxDeg], o[kMaxDeg];
      Acc m1 = A::kBig, m2 = A::kBig;
      int neg = 0;
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        if (d < deg) {
          int idx = k + eshift[e0 + d];
          if (idx >= Z) idx -= Z;
          t[d] = tot[ecol[e0 + d] * Z + idx];
          o[d] = A::load(msg[(size_t)(e0 + d) * Z + k]);
          const Acc v = A::sub(t[d], o[d]);
          const Acc a = A::absv(v);
          m2 = min(m2, max(m1, a));
          m1 = min(m1, a);
          neg ^= v < 0;
        }
      }
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        if (d < deg) {
          const Acc v = A::sub(t[d], o[d]);
          const Acc a = A::absv(v);
          const Acc mag = A::scale(a == m1 ? m2 : m1, alpha);
          const Acc nv = A::sat((neg ^ (v < 0)) ? -mag : mag);
          msg[(size_t)(e0 + d) * Z + k] = A::store(nv);
        }
      }
    }
    // variable-node pass: thread k rebuilds variable k of every column
    __syncthreads();
    for (int c = 0; c < cols; ++c) {
      Acc s = lsm[c * Z + k];
      for (int i = col_ptr[c]; i < col_ptr[c + 1]; ++i) {
        const int e = col_edge[i];
        int idx = k - eshift[e];
        if (idx < 0) idx += Z;
        s = A::add(s, A::load(msg[(size_t)e * Z + idx]));
      }
      tot[c * Z + k] = s;
    }
    __syncthreads();
    if (check_every > 0 && it % check_every == check_every - 1 &&
        !any_check_fails(tot, row_ptr, ecol, eshift, rows, k, Z))
      break;  // uniform: __syncthreads_or gives every thread the same value
  }
  for (int c = 0; c < K / Z; ++c)
    bits[(size_t)b * K + c * Z + k] = tot[c * Z + k] < 0;
  const int bad = any_check_fails(tot, row_ptr, ecol, eshift, rows, k, Z);
  if (k == 0) ok[b] = !bad;
}

template <int M, typename T>
int launch(const void* llr, void* bits, void* ok, void* c2v, const void* row_ptr,
           const void* ecol, const void* eshift, const void* col_ptr,
           const void* col_edge, int B, int rows, int cols, int E, int Z, int K,
           int n_iters, int check_every, float alpha, int device,
           cudaStream_t stream) {
  using A = Arith<M>;
  const int smem = 2 * cols * Z * (int)sizeof(typename A::acc);
  auto kernel = ldpc_flooding_kernel<M, T>;
  static SmemLimit limit;
  const cudaError_t err = limit.reserve(reinterpret_cast<const void*>(kernel), device, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, Z, smem, stream>>>(
      static_cast<const T*>(llr), static_cast<int8_t*>(bits),
      static_cast<uint8_t*>(ok), static_cast<typename A::msg*>(c2v),
      static_cast<const int*>(row_ptr), static_cast<const int*>(ecol),
      static_cast<const int*>(eshift), static_cast<const int*>(col_ptr),
      static_cast<const int*>(col_edge), rows, cols, E, Z, K, n_iters,
      check_every, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// llr (B, cols*Z) -> bits (B, K) int8, ok (B,) bool, under the flooding
// schedule.  in_kind: 0 f32, 1 bf16, 2 int32; msg_kind: 0 f32, 1 int8,
// 2 bf16 (the pairs decode_pallas forms: f32 msgs with f32/bf16 input,
// int8 msgs with int32 input, bf16 msgs with bf16 input).
// c2v: (B, E, Z) scratch of the message type; row_ptr (rows+1,),
// ecol/eshift (E,), col_ptr (cols+1,), col_edge (E,) int32.  For bf16
// messages `alpha` must already be rounded to bf16.  All tensors on CUDA
// device `device`.
extern "C" int ldpc_flooding_decode(const void* llr, int in_kind, int msg_kind,
                                    void* bits, void* ok, void* c2v,
                                    const void* row_ptr, const void* ecol,
                                    const void* eshift, const void* col_ptr,
                                    const void* col_edge, int B, int rows, int cols,
                                    int E, int Z, int K, int n_iters, int check_every,
                                    float alpha, int device, void* stream) {
  if (B == 0) return 0;
  if (Z > kMaxZ) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDPC_LAUNCH(M, T)                                                        \
  return launch<M, T>(llr, bits, ok, c2v, row_ptr, ecol, eshift, col_ptr,       \
                      col_edge, B, rows, cols, E, Z, K, n_iters, check_every,   \
                      alpha, device, s)
  if (msg_kind == kMsgF32 && in_kind == kInF32) LDPC_LAUNCH(kMsgF32, float);
  if (msg_kind == kMsgF32 && in_kind == kInBF16) LDPC_LAUNCH(kMsgF32, __nv_bfloat16);
  if (msg_kind == kMsgI8 && in_kind == kInI32) LDPC_LAUNCH(kMsgI8, int);
  if (msg_kind == kMsgBF16 && in_kind == kInBF16) LDPC_LAUNCH(kMsgBF16, __nv_bfloat16);
#undef LDPC_LAUNCH
  return (int)cudaErrorInvalidValue;
}
