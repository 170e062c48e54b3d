// The arithmetic of the port's LDPC decoders (K1's row-layered and
// flooding schedules, csrc/ldpc_layered.cu and csrc/ldpc_flooding.cu, and
// K2, bf16 layered in csrc/ldpc_layered.cu): one struct per message type
// with the accumulation type, how a total is kept in shared memory, how the
// check-node state's two magnitudes are kept in device memory, and each
// operation of the min-sum update, so that every operation is the one of
// ldpc_pallas.py:225-275 (K2: :427-489) in the same order.  f32 uses the
// _rn intrinsics so that no FMA forms; bf16 computes each operation in f32
// and rounds it to bf16 (what XLA and PyTorch do on the CPU), never a
// native bf16 chain; int8 messages live in int32 arithmetic with ±127
// saturation and alpha = 13/16 in integers.  Each struct also says how a
// total is kept in shared memory (`tot`, get, put) and how the check-node
// state's two magnitudes are kept in device memory (`mags`, pack, unpack).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace oai5g {

// kMsgK2: K2's bf16 sign-magnitude decoder, bf16 arithmetic whose sign is
// the sign bit (-0.0 counts as negative in the check-node sign and the
// parity flag) and which ignores check_every
enum MsgKind { kMsgF32 = 0, kMsgI8 = 1, kMsgBF16 = 2, kMsgK2 = 3 };
enum InKind { kInF32 = 0, kInBF16 = 1, kInI32 = 2 };

template <int M> struct Arith;

template <> struct Arith<kMsgF32> {
  using acc = float;
  using tot = float;             // a total in shared memory
  using mags = float2;           // the state's (s1, s2) in device memory
  static constexpr float kBig = 1e30f;
  __device__ static float get(float t) { return t; }
  __device__ static float put(float v) { return v; }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float scale(float m, float alpha) { return __fmul_rn(m, alpha); }
  __device__ static float absv(float v) { return fabsf(v); }
  __device__ static float sat(float v) { return v; }
  __device__ static bool is_neg(float v) { return v < 0; }
  // -mag where neg is 1, for mag >= +0.0: setting the sign bit negates,
  // -0.0 included
  __device__ static float with_sign(float mag, unsigned neg) {
    return __uint_as_float(__float_as_uint(mag) | (neg << 31));
  }
  __device__ static float2 pack(float s1, float s2) { return make_float2(s1, s2); }
  __device__ static void unpack(float2 m, float& s1, float& s2) { s1 = m.x; s2 = m.y; }
};

template <> struct Arith<kMsgBF16> {
  using acc = float;             // always holds a bf16 value
  using tot = __nv_bfloat16;     // so a total is kept exactly in bf16
  using mags = unsigned;         // the two bf16 magnitudes, s1 in the low half
  static constexpr float kBig = 3e38f;
  __device__ static float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static float get(__nv_bfloat16 t) { return __bfloat162float(t); }
  __device__ static __nv_bfloat16 put(float v) { return __float2bfloat16_rn(v); }
  __device__ static float sub(float a, float b) { return rb(__fsub_rn(a, b)); }
  __device__ static float add(float a, float b) { return rb(__fadd_rn(a, b)); }
  // alpha arrives rounded to bf16 (the host rounds it)
  __device__ static float scale(float m, float alpha) { return rb(__fmul_rn(m, alpha)); }
  __device__ static float absv(float v) { return fabsf(v); }
  __device__ static float sat(float v) { return v; }
  __device__ static bool is_neg(float v) { return v < 0; }
  __device__ static float with_sign(float mag, unsigned neg) {
    return __uint_as_float(__float_as_uint(mag) | (neg << 31));
  }
  // a bf16 value is the high half of its f32 bits; magnitudes are >= +0.0
  __device__ static unsigned pack(float s1, float s2) {
    return (__float_as_uint(s1) >> 16) | (__float_as_uint(s2) & 0xFFFF0000u);
  }
  __device__ static void unpack(unsigned m, float& s1, float& s2) {
    s1 = __uint_as_float(m << 16);
    s2 = __uint_as_float(m & 0xFFFF0000u);
  }
};

template <> struct Arith<kMsgK2> : Arith<kMsgBF16> {
  __device__ static bool is_neg(float v) { return __float_as_uint(v) >> 31; }
};

template <> struct Arith<kMsgI8> {
  using acc = int;
  using tot = int;
  using mags = int2;
  static constexpr int kBig = 1 << 30;
  __device__ static int get(int t) { return t; }
  __device__ static int put(int v) { return v; }
  __device__ static int sub(int a, int b) { return a - b; }
  __device__ static int add(int a, int b) { return a + b; }
  __device__ static int scale(int m, float) { return (m * 13 + 8) >> 4; }  // 13/16
  __device__ static int absv(int v) { return abs(v); }
  __device__ static int sat(int v) { return min(127, max(-127, v)); }
  __device__ static bool is_neg(int v) { return v < 0; }
  __device__ static int with_sign(int mag, unsigned neg) { return neg ? -mag : mag; }
  __device__ static int2 pack(int s1, int s2) { return make_int2(s1, s2); }
  __device__ static void unpack(int2 m, int& s1, int& s2) { s1 = m.x; s2 = m.y; }
};

__device__ __forceinline__ float load_llr(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_llr(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ int load_llr(const int* p, size_t i) { return p[i]; }

}  // namespace oai5g
