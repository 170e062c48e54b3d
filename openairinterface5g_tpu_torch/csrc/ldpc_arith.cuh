// The arithmetic K1's two decoders share (csrc/ldpc_layered.cu for the
// row-layered schedule, csrc/ldpc_decoder.cu for flooding): one struct per
// message type with the accumulation type, the message storage and each
// operation of the min-sum update, so that every operation is the one of
// ldpc_pallas.py:225-275 in the same order.  f32 uses the _rn intrinsics
// so that no FMA forms; bf16 computes each operation in f32 and rounds it
// to bf16 (what XLA and PyTorch do on the CPU), never a native bf16 chain;
// int8 messages live in int32 totals with ±127 saturation and
// alpha = 13/16 in integers.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace oai5g {

enum MsgKind { kMsgF32 = 0, kMsgI8 = 1, kMsgBF16 = 2 };
enum InKind { kInF32 = 0, kInBF16 = 1, kInI32 = 2 };

template <int M> struct Arith;

template <> struct Arith<kMsgF32> {
  using acc = float;
  using msg = float;
  static constexpr float kBig = 1e30f;
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float scale(float m, float alpha) { return __fmul_rn(m, alpha); }
  __device__ static float absv(float v) { return fabsf(v); }
  __device__ static float sat(float v) { return v; }
  // -mag where neg is 1, for mag >= +0.0: setting the sign bit negates,
  // -0.0 included
  __device__ static float with_sign(float mag, unsigned neg) {
    return __uint_as_float(__float_as_uint(mag) | (neg << 31));
  }
  __device__ static float load(msg m) { return m; }
  __device__ static msg store(float v) { return v; }
};

template <> struct Arith<kMsgBF16> {
  using acc = float;             // always holds a bf16 value
  using msg = __nv_bfloat16;
  static constexpr float kBig = 3e38f;
  __device__ static float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static float sub(float a, float b) { return rb(__fsub_rn(a, b)); }
  __device__ static float add(float a, float b) { return rb(__fadd_rn(a, b)); }
  // alpha arrives rounded to bf16 (the host rounds it)
  __device__ static float scale(float m, float alpha) { return rb(__fmul_rn(m, alpha)); }
  __device__ static float absv(float v) { return fabsf(v); }
  __device__ static float sat(float v) { return v; }
  __device__ static float load(msg m) { return __bfloat162float(m); }
  __device__ static msg store(float v) { return __float2bfloat16_rn(v); }
};

template <> struct Arith<kMsgI8> {
  using acc = int;
  using msg = int8_t;
  static constexpr int kBig = 1 << 30;
  __device__ static int sub(int a, int b) { return a - b; }
  __device__ static int add(int a, int b) { return a + b; }
  __device__ static int scale(int m, float) { return (m * 13 + 8) >> 4; }  // 13/16
  __device__ static int absv(int v) { return abs(v); }
  __device__ static int sat(int v) { return min(127, max(-127, v)); }
  __device__ static int with_sign(int mag, unsigned neg) { return neg ? -mag : mag; }
  __device__ static int load(msg m) { return m; }
  __device__ static msg store(int v) { return static_cast<msg>(v); }
};

__device__ __forceinline__ float load_llr(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_llr(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ int load_llr(const int* p, size_t i) { return p[i]; }

}  // namespace oai5g
