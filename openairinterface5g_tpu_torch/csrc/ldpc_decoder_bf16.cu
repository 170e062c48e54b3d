// K2: bf16 sign-magnitude layered min-sum LDPC decoder (NR BG1 and BG2).
//
// Replaces the Pallas kernel openairinterface5g_tpu/ops/ldpc_pallas.py::
// _build_decoder_bf16, which decode_pallas runs for bf16 messages under the
// layered schedule.  Same function (ldpc_pallas.py:427-489):
//   * input LLRs clipped to ±24 and rounded to bf16 (by the wrapper);
//   * per row r and check node k, for each edge (c, s):
//       v = bf16(total[c][(k + s) % Z] - c2v_old), sign = v's sign BIT,
//       |v| = v with the sign bit cleared;
//     the excluded minimum of the row's |v| (min1/min2, the same function
//     as the Pallas prefix/suffix sweeps), mag = bf16(excl * alpha);
//     c2v_new = mag with sign bit (XOR of the row's sign bits ^ own bit);
//     total = bf16(t + bf16(c2v_new - c2v_old));
//   * hard bits from soft < 0; the parity flag from the XOR syndrome of
//     the totals' sign bits.  So a total of -0.0 gives bit 0 and yet a
//     sign of 1 in the flag and in later check-node signs, as in Pallas.
//   * no early stop: the Pallas kernel takes `check_every` and never reads
//     it, so this kernel always runs n_iters iterations.
// Every bf16 operation is computed in f32 and rounded to bf16 (round to
// nearest even), as XLA and PyTorch do on the CPU, never a native bf16
// chain, so the hard bits equal the plain version's bit for bit.
//
// What bounds it on an H100.  The bf16 messages of one BG1 code block at
// Z = 384 take 316 x 384 x 2 = 242,688 B, more than the 232,448 B of shared
// memory a block may use beside the 52 KB of bf16 totals, so they stay in
// a (B, E, Z) device-memory scratch as K1's do: half K1's f32 message
// traffic, which is what bounds both kernels.
//
// Design.  As K1: one thread block per code block, Z threads, thread k is
// check node k of every layer; totals in shared memory (bf16), messages
// read and written coalesced; one __syncthreads() between layers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxDeg = 19;
constexpr int kMaxZ = 384;
constexpr uint16_t kSign = 0x8000;

__device__ __forceinline__ uint16_t bits_of(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ __nv_bfloat16 of_bits(uint16_t w) { return __ushort_as_bfloat16(w); }
__device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
// one bf16 operation: computed in f32, rounded to bf16
__device__ __forceinline__ __nv_bfloat16 sub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fsub_rn(f(a), f(b)));
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(f(a), f(b)));
}

// 1 in every thread if any row's XOR of the totals' sign bits is set.
__device__ int any_sign_check_fails(const __nv_bfloat16* tot,
                                    const int* __restrict__ row_ptr,
                                    const int* __restrict__ ecol,
                                    const int* __restrict__ eshift, int rows,
                                    int k, int Z) {
  uint16_t bad = 0;
  for (int r = 0; r < rows; ++r) {
    uint16_t syn = 0;
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      int idx = k + eshift[e];
      if (idx >= Z) idx -= Z;
      syn ^= bits_of(tot[ecol[e] * Z + idx]) & kSign;
    }
    bad |= syn;
  }
  return __syncthreads_or(bad != 0);
}

__global__ void __launch_bounds__(kMaxZ)
ldpc_bf16_kernel(const __nv_bfloat16* __restrict__ llr, int8_t* __restrict__ bits,
                 uint8_t* __restrict__ ok, __nv_bfloat16* __restrict__ c2v,
                 const int* __restrict__ row_ptr, const int* __restrict__ ecol,
                 const int* __restrict__ eshift, int rows, int cols, int E,
                 int Z, int K, int n_iters, float alpha_bf) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tot = reinterpret_cast<__nv_bfloat16*>(smem);  // (cols, Z)
  const int b = blockIdx.x;
  const int k = threadIdx.x;                                      // blockDim.x == Z
  const __nv_bfloat16* llr_b = llr + (size_t)b * cols * Z;
  __nv_bfloat16* msg = c2v + (size_t)b * E * Z;
  const __nv_bfloat16 zero = of_bits(0);

  for (int i = k; i < cols * Z; i += Z) tot[i] = llr_b[i];
  for (int e = 0; e < E; ++e) msg[(size_t)e * Z + k] = zero;
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    for (int r = 0; r < rows; ++r) {
      const int e0 = row_ptr[r];
      const int deg = row_ptr[r + 1] - e0;
      int pos[kMaxDeg];
      __nv_bfloat16 t[kMaxDeg], o[kMaxDeg];
      float m1 = 3e38f, m2 = 3e38f;
      uint16_t sgn_all = 0;
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        if (d < deg) {
          int idx = k + eshift[e0 + d];
          if (idx >= Z) idx -= Z;
          pos[d] = ecol[e0 + d] * Z + idx;
          t[d] = tot[pos[d]];
          o[d] = msg[(size_t)(e0 + d) * Z + k];
          const uint16_t w = bits_of(sub(t[d], o[d]));
          const float a = f(of_bits(w & ~kSign));
          m2 = fminf(m2, fmaxf(m1, a));
          m1 = fminf(m1, a);
          sgn_all ^= w & kSign;
        }
      }
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        if (d < deg) {
          const uint16_t w = bits_of(sub(t[d], o[d]));
          const float a = f(of_bits(w & ~kSign));
          const __nv_bfloat16 mag = __float2bfloat16_rn(__fmul_rn(a == m1 ? m2 : m1, alpha_bf));
          const __nv_bfloat16 val = of_bits(bits_of(mag) ^ (sgn_all ^ (w & kSign)));
          tot[pos[d]] = add(t[d], sub(val, o[d]));
          msg[(size_t)(e0 + d) * Z + k] = val;
        }
      }
      __syncthreads();
    }
  }
  for (int c = 0; c < K / Z; ++c)
    bits[(size_t)b * K + c * Z + k] = f(tot[c * Z + k]) < 0.f;
  const int bad = any_sign_check_fails(tot, row_ptr, ecol, eshift, rows, k, Z);
  if (k == 0) ok[b] = !bad;
}

}  // namespace

// llr (B, cols*Z) bf16, clipped to ±24 -> bits (B, K) int8, ok (B,) bool.
// c2v: (B, E, Z) bf16 scratch; row_ptr (rows+1,), ecol/eshift (E,) int32;
// alpha_bf: alpha already rounded to bf16.  All tensors on CUDA device
// `device`.
extern "C" int ldpc_decode_bf16(const void* llr, void* bits, void* ok, void* c2v,
                                const void* row_ptr, const void* ecol,
                                const void* eshift, int B, int rows, int cols,
                                int E, int Z, int K, int n_iters, float alpha_bf,
                                int device, void* stream) {
  if (B == 0) return 0;
  if (Z > kMaxZ) return (int)cudaErrorInvalidValue;
  const oai5g::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int smem = cols * Z * (int)sizeof(__nv_bfloat16);
  static oai5g::SmemLimit limit;
  const cudaError_t err =
      limit.reserve(reinterpret_cast<const void*>(ldpc_bf16_kernel), device, smem);
  if (err != cudaSuccess) return (int)err;
  ldpc_bf16_kernel<<<B, Z, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(llr), static_cast<int8_t*>(bits),
      static_cast<uint8_t*>(ok), static_cast<__nv_bfloat16*>(c2v),
      static_cast<const int*>(row_ptr), static_cast<const int*>(ecol),
      static_cast<const int*>(eshift), rows, cols, E, Z, K, n_iters, alpha_bf);
  return (int)cudaGetLastError();
}
