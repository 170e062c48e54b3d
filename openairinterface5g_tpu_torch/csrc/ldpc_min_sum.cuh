// What the port's LDPC decoders share (csrc/ldpc_layered.cu: K1 layered
// and K2; csrc/ldpc_flooding.cu: K1 flooding): one thread block per code
// block, Z threads, thread k is check node k of every row; the totals in
// shared memory; per (row, lane) a compressed check-node state in device
// memory instead of messages; the rows taken in layers of orthogonal rows,
// one barrier per layer.  decode_block runs either schedule.
//
// The compressed state.  Per (row, lane) the decoder keeps s1 =
// sat(scale(m1)), s2 = sat(scale(m2)) and one word: the outgoing messages'
// signs (bit d) and d*, the first edge whose |v| equals m1 (bits 19-23).
// The message to edge d is then ±(d == d* ? s2 : s1), exactly the value of
// ldpc_pallas.py's update ±scale(|v_d| == m1 ? m2 : m1): an edge d != d*
// with |v_d| == m1 means m1 is taken twice, so m2 == m1; the stored sign
// bit gives back -0.0 where the update made it.  Zero messages are the
// state (0, 0, any d*, no signs), so the first iteration reads no state and
// nothing is zero-filled.  f32 and int8: 12 B per (row, lane), 44 MB at
// 208 BG1 Z=384 code blocks, which stays in the 50 MB L2; bf16 packs both
// magnitudes in one word, 8 B (packing int8's cost more than it saved).
//
// Layers.  A host table groups consecutive rows that share no column into
// one layer (BG1: 46 rows in 32 layers, BG2: 42 in 28, at most 3 rows).
//   * Row-layered (K1 layered, K2): each row reads its totals, updates its
//     state and writes t + (new - old) back; rows of one layer touch
//     disjoint totals, so one barrier per layer changes no bit.
//   * Flooding: the totals of the last iteration stay fixed (`cur`); each
//     row adds its new messages into a second buffer (`nxt`) that starts
//     from the LLRs.  A layer's rows add to disjoint positions and the
//     barrier between layers orders the additions, so every position
//     receives llr + c2v(r1) + c2v(r2) + ... in ascending row order, the
//     order of ldpc_pallas.py:240-245 and decode_plain.  The buffers swap
//     after each iteration, and the LLRs are read again (from L2) into the
//     new `nxt`.
// The state of the next layer is loaded before each barrier: a thread's
// state for a row is its own, written one iteration earlier.
//
// The graph lives in shared memory: per layer (first row, rows), per row
// (first edge, degree), per edge (col * Z, shift), about 1.6 KB for BG1,
// read by every thread at the same address (a broadcast).  Each row is
// unrolled to its exact degree (3-10 and 19, the NR base graphs'), never a
// guarded loop over 19 slots.
//
// The syndrome check, where Z is a multiple of 32, works on the totals'
// signs packed 32 lanes to a word (a ballot per warp and column, then
// funnel shifts); else it walks each row's edges.  A check of the final
// totals is reused for the `ok` flag.  The early stop is per code block:
// after every `check_every`-th iteration a block-wide check
// (__syncthreads_or) ends that block's decode alone.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "ldpc_arith.cuh"

namespace oai5g {

constexpr int kMaxDeg = 19;      // largest check-node degree of BG1 (BG2: 10)
constexpr int kMaxZ = 384;       // largest lifting size: one thread per lane
constexpr int kMaxRows = 3;      // rows in one layer (BG1: 2, BG2: 3)
constexpr int kDstarShift = kMaxDeg;          // d* above the sign bits
constexpr unsigned kSignMask = (1u << kMaxDeg) - 1;

// Everything a decode kernel is given (one struct, passed by value).
struct DecodeArgs {
  const void* llr;         // (B, cols * Z), of the input type
  int8_t* bits;            // (B, K)
  uint8_t* ok;             // (B,)
  int* iters;              // (B,) iterations run, or null
  void* state;             // (B, rows, Z) magnitudes, then (B, rows, Z) words
  const int* tables;       // layers, then rows, then edges
  int layers, rows, cols, E, Z, K, n_iters, check_every;
  float alpha;
};

// The check-node state of one (row, lane).
template <typename Acc> struct State {
  Acc s1, s2;     // sat(scale(m1)), sat(scale(m2))
  unsigned w;     // outgoing signs (bit d) | d* << kDstarShift
};

template <class A>
__device__ __forceinline__ State<typename A::acc> load_state(const typename A::mags* mag,
                                                             const unsigned* w, int i) {
  State<typename A::acc> s;
  A::unpack(__ldcg(mag + i), s.s1, s.s2);
  s.w = __ldcg(w + i);
  return s;
}

template <class A>
__device__ __forceinline__ void store_state(typename A::mags* mag, unsigned* w, int i,
                                            const State<typename A::acc>& s) {
  __stcg(mag + i, A::pack(s.s1, s.s2));
  __stcg(w + i, s.w);
}

// The message the state gives edge d.
template <class A>
__device__ __forceinline__ typename A::acc message(const State<typename A::acc>& s, int d) {
  const typename A::acc mag = (int)(s.w >> kDstarShift) == d ? s.s2 : s.s1;
  return A::with_sign(mag, (s.w >> d) & 1u);
}

// Position in the (cols, Z) totals of edge `ent` = col * Z | shift << 16
// at lane k.
__device__ __forceinline__ int edge_pos(int ent, int k, int Z) {
  int idx = k + (ent >> 16);
  if (idx >= Z) idx -= Z;
  return (ent & 0xFFFF) + idx;
}

// One row's update at lane k: reads the totals of its D edges from `cur`
// and the old state, and returns the new state.  Row-layered (cur == nxt):
// writes each total t + (new - old) back.  Flooding: adds each new message
// into `nxt`.  kFirst: the first iteration, every old message +0.0
// (t - 0 == t and nv - 0 == nv exactly, -0.0 included).
//
// d* is the first edge with the least |v|.  The message to edge d is
// ±scale(|v_d| == m1 ? m2 : m1), and (d == d* ? m2 : m1) is the same
// value, so the second pass needs no v.  It reads each total again (in
// this layer no other thread writes it) and, for rows of degree up to 10,
// takes the edges' positions from the first, two 16-bit positions to a
// register; the 19-edge rows compute them again, which keeps the
// registers under the two-blocks-per-SM cap without spilling.
template <class A, bool kFirst, bool kFlood, int D>
__device__ __forceinline__ State<typename A::acc> row_update_d(
    const typename A::tot* cur, typename A::tot* nxt, const int* etab, int e0, int k, int Z,
    float alpha, const State<typename A::acc>& old) {
  using Acc = typename A::acc;
  constexpr bool kKeepPos = D <= 10;
  unsigned pk[kKeepPos ? (D + 1) / 2 : 1];
  Acc m1 = A::kBig, m2 = A::kBig;
  unsigned neg = 0, dstar = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int pos = edge_pos(etab[e0 + d], k, Z);
    if (kKeepPos) pk[d / 2] = d % 2 ? pk[d / 2] | (unsigned)pos << 16 : (unsigned)pos;
    const Acc t = A::get(cur[pos]);
    const Acc v = kFirst ? t : A::sub(t, message<A>(old, d));
    const Acc a = A::absv(v);
    dstar = a < m1 ? d : dstar;
    m2 = min(m2, max(m1, a));
    m1 = min(m1, a);
    neg |= (unsigned)A::is_neg(v) << d;
  }
  const unsigned sgn = (__popc(neg) & 1) ? neg ^ kSignMask : neg;
  const Acc s1 = A::sat(A::scale(m1, alpha));
  const Acc s2 = A::sat(A::scale(m2, alpha));
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int pos = kKeepPos ? (int)(d % 2 ? pk[d / 2] >> 16 : pk[d / 2] & 0xFFFFu)
                             : edge_pos(etab[e0 + d], k, Z);
    const Acc t = A::get(nxt[pos]);
    const Acc nv = A::with_sign(d == (int)dstar ? s2 : s1, (sgn >> d) & 1u);
    if (kFlood || kFirst)
      nxt[pos] = A::put(A::add(t, nv));
    else
      nxt[pos] = A::put(A::add(t, A::sub(nv, message<A>(old, d))));
  }
  return {s1, s2, (sgn & kSignMask) | (dstar << kDstarShift)};
}

// A row's update, unrolled to its exact degree: the NR base graphs have
// rows of degree 3 to 10 and 19 (BG1 rows 0-3; the wrapper's table holds
// no other).
template <class A, bool kFirst, bool kFlood>
__device__ __forceinline__ State<typename A::acc> row_update(
    const typename A::tot* cur, typename A::tot* nxt, const int* etab, int rinfo, int k, int Z,
    float alpha, const State<typename A::acc>& old) {
  const int e0 = rinfo & 0xFFFF;
  const int deg = rinfo >> 16;
#define ROW_CASE(D) \
  case D: return row_update_d<A, kFirst, kFlood, D>(cur, nxt, etab, e0, k, Z, alpha, old);
  switch (deg) {
    ROW_CASE(3) ROW_CASE(4) ROW_CASE(5) ROW_CASE(6) ROW_CASE(7) ROW_CASE(8)
    ROW_CASE(9) ROW_CASE(10)
    default:  // 19
      return row_update_d<A, kFirst, kFlood, kMaxDeg>(cur, nxt, etab, e0, k, Z, alpha, old);
  }
#undef ROW_CASE
}

// One iteration over every layer, each ending in a barrier.  `nxs` holds
// the state of the first layer's rows on entry (unused when kFirst) and,
// where `prefetch_next`, the next iteration's on exit.
template <class A, bool kFirst, bool kFlood>
__device__ __forceinline__ void iteration(
    const typename A::tot* cur, typename A::tot* nxt, const int* lay, const int* rtab,
    const int* etab, typename A::mags* mag, unsigned* word, int layers, int k, int Z,
    float alpha, State<typename A::acc> (&nxs)[kMaxRows], bool prefetch_next) {
  using S = State<typename A::acc>;
  for (int l = 0; l < layers; ++l) {
    const int li = lay[l];
    const int r0 = li & 0xFFFF;
    const int nr = li >> 16;
    S cs[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) cs[j] = nxs[j];
#pragma unroll 1
    for (int j = 0; j < nr; ++j) {
      const int r = r0 + j;
      store_state<A>(mag, word, r * Z + k,
                     row_update<A, kFirst, kFlood>(cur, nxt, etab, rtab[r], k, Z, alpha, cs[0]));
#pragma unroll
      for (int i = 0; i + 1 < kMaxRows; ++i) cs[i] = cs[i + 1];
    }
    // the next layer's state, before the barrier
    const bool last = l + 1 == layers;
    if (last ? prefetch_next : !kFirst) {
      const int ln = lay[last ? 0 : l + 1];
      const int rn = ln & 0xFFFF;
      const int nn = ln >> 16;
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j)
        if (j < nn) nxs[j] = load_state<A>(mag, word, (rn + j) * Z + k);
    }
    __syncthreads();
  }
}

// The parity of the D-edge row from edge e0 at lane k: XOR of its totals'
// signs (A::is_neg).
template <class A, int D>
__device__ __forceinline__ int row_parity_d(const typename A::tot* tot, const int* etab,
                                            int e0, int k, int Z) {
  int par = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) par ^= A::is_neg(A::get(tot[edge_pos(etab[e0 + d], k, Z)]));
  return par;
}

// 1 in every thread if any parity check of the code block fails; each row
// unrolled to its exact degree, as in row_update.
template <class A>
__device__ int any_check_fails(const typename A::tot* tot, const int* rtab, const int* etab,
                               int rows, int k, int Z) {
  int bad = 0;
  for (int r = 0; r < rows; ++r) {
    const int ri = rtab[r];
    const int e0 = ri & 0xFFFF;
    const int deg = ri >> 16;
#define CHECK_CASE(D) \
  case D: bad |= row_parity_d<A, D>(tot, etab, e0, k, Z); break;
    switch (deg) {
      CHECK_CASE(3) CHECK_CASE(4) CHECK_CASE(5) CHECK_CASE(6) CHECK_CASE(7) CHECK_CASE(8)
      CHECK_CASE(9) CHECK_CASE(10)
      default: bad |= row_parity_d<A, kMaxDeg>(tot, etab, e0, k, Z);   // 19
    }
#undef CHECK_CASE
  }
  return __syncthreads_or(bad);
}

// The same flag from the totals' signs packed 32 lanes to a word, where
// Z is a multiple of 32 (the main path's 384, and 32-352 in steps of 32):
// each warp ballots its 32 lanes of every column into `hard` (cols x Z/32
// words), then a thread takes one 32-lane word of a row and XORs, per
// edge, the column's word window that starts at the edge's shift: a
// cyclic funnel shift of two words.  32 lanes' parity per operation,
// where the walk above takes one.
template <class A>
__device__ int any_check_fails_packed(const typename A::tot* tot, unsigned* hard,
                                      const int* rtab, const int* etab, int rows, int cols,
                                      int k, int Z) {
  const int nw = Z >> 5;
  for (int c = 0; c < cols; ++c) {
    const unsigned m = __ballot_sync(0xffffffffu, A::is_neg(A::get(tot[c * Z + k])));
    if ((k & 31) == 0) hard[c * nw + (k >> 5)] = m;
  }
  __syncthreads();
  int bad = 0;
  for (int task = k; task < rows * nw; task += Z) {
    const int r = task / nw;
    const int base = (task - r * nw) << 5;        // the word's first lane
    const int ri = rtab[r];
    const int e0 = ri & 0xFFFF;
    const int deg = ri >> 16;
    unsigned x = 0;
    for (int d = 0; d < deg; ++d) {
      const int ent = etab[e0 + d];
      int p = base + (ent >> 16);                 // lane `base` meets bit p
      if (p >= Z) p -= Z;
      const unsigned* col = hard + ((ent & 0xFFFF) >> 5);   // (c * Z) / 32 = c * nw
      const int i = p >> 5;
      x ^= __funnelshift_r(col[i], col[i + 1 == nw ? 0 : i + 1], p & 31);
    }
    bad |= x != 0;
  }
  return __syncthreads_or(bad);
}

// The code block's LLRs into a (cols, Z) totals buffer: 16-byte loads,
// kFillLoads of them in flight per thread, where the block's LLRs are
// whole aligned 16-byte words (cols * Z a multiple of 8 for bf16 input, of
// 4 for f32 and int32, as at Z = 384); else one value per load.  kAgain:
// the LLRs are read again later (flooding), so they are cached in L2 as
// usual; else they are read once, and streamed.
constexpr int kFillLoads = 8;

__device__ __forceinline__ void unpack_llr(const uint4& w, float* dst, const float*) {
  dst[0] = __uint_as_float(w.x); dst[1] = __uint_as_float(w.y);
  dst[2] = __uint_as_float(w.z); dst[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack_llr(const uint4& w, int* dst, const int*) {
  dst[0] = (int)w.x; dst[1] = (int)w.y; dst[2] = (int)w.z; dst[3] = (int)w.w;
}
__device__ __forceinline__ void unpack_llr(const uint4& w, float* dst, const __nv_bfloat16*) {
  const unsigned v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // bf16 -> f32 is exact: the bits, shifted
    dst[2 * i] = __uint_as_float(v[i] << 16);
    dst[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
  }
}

template <class A, bool kAgain, typename T>
__device__ __forceinline__ void fill_totals(typename A::tot* tot, const T* src, int n, int k,
                                            int nt) {
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    const int nv = n / V;
    for (int base = k; base < nv; base += kFillLoads * nt) {
      uint4 w[kFillLoads];
#pragma unroll
      for (int u = 0; u < kFillLoads; ++u)
        if (base + u * nt < nv) w[u] = kAgain ? __ldcg(s + base + u * nt)
                                              : __ldcs(s + base + u * nt);
#pragma unroll
      for (int u = 0; u < kFillLoads; ++u)
        if (base + u * nt < nv) {
          typename A::acc x[V];
          unpack_llr(w[u], x, src);
          typename A::tot* dst = tot + (size_t)(base + u * nt) * V;
#pragma unroll
          for (int i = 0; i < V; ++i) dst[i] = A::put(x[i]);
        }
    }
  } else {
    for (int i = k; i < n; i += nt) tot[i] = A::put(load_llr(src, i));
  }
}

// Bytes of one (cols, Z) totals buffer in shared memory, kept a multiple
// of 16 so that what follows it stays aligned.
template <class A>
__host__ __device__ constexpr int totals_bytes(int cols, int Z) {
  return (cols * Z * (int)sizeof(typename A::tot) + 15) & ~15;
}

// Dynamic shared memory of a decode: the totals (two buffers under
// flooding), the graph table, and the packed hard decisions where Z % 32
// == 0.
template <class A, bool kFlood>
int decode_smem(int layers, int rows, int cols, int E, int Z) {
  return (kFlood ? 2 : 1) * totals_bytes<A>(cols, Z) + (layers + rows + E) * (int)sizeof(int) +
         ((Z & 31) == 0 ? cols * (Z >> 5) * (int)sizeof(unsigned) : 0);
}

// One code block's decode (blockIdx.x) under either schedule, then its
// hard bits (t < 0), ok flag (a check of the final totals) and the number
// of iterations it ran.  K2 (kMsgK2) runs all n_iters iterations.
template <int M, typename T, bool kFlood>
__device__ __forceinline__ void decode_block(const DecodeArgs& p) {
  using A = Arith<M>;
  using Tot = typename A::tot;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = p.Z, cols = p.cols, layers = p.layers, rows = p.rows;
  const int check_every = M == kMsgK2 ? 0 : p.check_every;   // K2 has no early stop
  Tot* cur = reinterpret_cast<Tot*>(smem);                    // (cols, Z)
  Tot* nxt = kFlood ? reinterpret_cast<Tot*>(smem + totals_bytes<A>(cols, Z)) : cur;
  int* lay = reinterpret_cast<int*>(smem + (kFlood ? 2 : 1) * totals_bytes<A>(cols, Z));
  const int* rtab = lay + layers;                             // (layers,) then rows, edges
  const int* etab = rtab + rows;
  unsigned* hard = reinterpret_cast<unsigned*>(lay + layers + rows + p.E);  // (cols, Z/32)
  const bool packed = (Z & 31) == 0;
  const int b = blockIdx.x;
  const int k = threadIdx.x;                                  // blockDim.x == Z
  const T* llr = static_cast<const T*>(p.llr) + (size_t)b * cols * Z;
  const size_t n_state = (size_t)gridDim.x * rows * Z;
  auto* mag = static_cast<typename A::mags*>(p.state) + (size_t)b * rows * Z;
  unsigned* word = reinterpret_cast<unsigned*>(static_cast<typename A::mags*>(p.state) + n_state) +
                   (size_t)b * rows * Z;

  for (int i = k; i < layers + rows + p.E; i += Z) lay[i] = p.tables[i];
  fill_totals<A, kFlood>(cur, llr, cols * Z, k, Z);
  if (kFlood) fill_totals<A, kFlood>(nxt, llr, cols * Z, k, Z);
  __syncthreads();

  State<typename A::acc> nxs[kMaxRows] = {};
  int bad = -1;          // the flag of a check of the current totals; -1: none yet
  int it = 0;
  while (it < p.n_iters) {
    if (kFlood && it > 0) {      // nxt held the totals before the last iteration
      fill_totals<A, kFlood>(nxt, llr, cols * Z, k, Z);
      __syncthreads();
    }
    if (it == 0)
      iteration<A, true, kFlood>(cur, nxt, lay, rtab, etab, mag, word, layers, k, Z, p.alpha,
                                 nxs, p.n_iters > 1);
    else
      iteration<A, false, kFlood>(cur, nxt, lay, rtab, etab, mag, word, layers, k, Z, p.alpha,
                                  nxs, it + 1 < p.n_iters);
    if (kFlood) {
      Tot* t = cur;
      cur = nxt;
      nxt = t;
    }
    ++it;
    bad = -1;
    if (check_every > 0 && it % check_every == 0) {
      bad = packed ? any_check_fails_packed<A>(cur, hard, rtab, etab, rows, cols, k, Z)
                   : any_check_fails<A>(cur, rtab, etab, rows, k, Z);
      if (!bad) break;   // uniform: __syncthreads_or gives every thread the same value
    }
  }
  for (int c = 0; c < p.K / Z; ++c)
    p.bits[(size_t)b * p.K + c * Z + k] = A::get(cur[c * Z + k]) < 0;
  if (bad < 0)
    bad = packed ? any_check_fails_packed<A>(cur, hard, rtab, etab, rows, cols, k, Z)
                 : any_check_fails<A>(cur, rtab, etab, rows, k, Z);
  if (k == 0) {
    p.ok[b] = !bad;
    if (p.iters) p.iters[b] = it;
  }
}

// Launches `kernel` (a __global__ around decode_block<M, T, kFlood>) over
// the B code blocks of `p` on `stream`, raising its shared-memory limit
// where this launch needs more than every earlier one.
template <int M, typename T, bool kFlood>
int launch_decode(void (*kernel)(DecodeArgs), const DecodeArgs& p, int B, int device,
                  cudaStream_t stream) {
  const int smem = decode_smem<Arith<M>, kFlood>(p.layers, p.rows, p.cols, p.E, p.Z);
  static SmemLimit limit;
  const cudaError_t err = limit.reserve(reinterpret_cast<const void*>(kernel), device, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, p.Z, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The entry points' common part, run under the caller's device guard: the
// launch of `Kernel<M, T>::launch` for the (message, input) pair.  f32
// messages take f32 or bf16 input and int8 messages int32 input under
// either schedule; bf16 messages take bf16 input, flooding only, and K2
// bf16 input, layered only; any other pair, or Z > 384, is refused.
template <bool kFlood, template <int, typename> class Kernel>
int decode_entry(const void* llr, int in_kind, int msg_kind, void* bits, void* ok, void* iters,
                 void* state, const void* tables, int B, int layers, int rows, int cols, int E,
                 int Z, int K, int n_iters, int check_every, float alpha, int device,
                 void* stream) {
  if (Z > kMaxZ) return (int)cudaErrorInvalidValue;
  const DecodeArgs p{llr, static_cast<int8_t*>(bits), static_cast<uint8_t*>(ok),
                     static_cast<int*>(iters), state, static_cast<const int*>(tables),
                     layers, rows, cols, E, Z, K, n_iters, check_every, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kMsgBF16Kind = kFlood ? kMsgBF16 : kMsgK2;
#define LDPC_LAUNCH(MK, T) return Kernel<MK, T>::launch(p, B, device, s)
  if (msg_kind == kMsgF32 && in_kind == kInF32) LDPC_LAUNCH(kMsgF32, float);
  if (msg_kind == kMsgF32 && in_kind == kInBF16) LDPC_LAUNCH(kMsgF32, __nv_bfloat16);
  if (msg_kind == kMsgI8 && in_kind == kInI32) LDPC_LAUNCH(kMsgI8, int);
  if (msg_kind == kMsgBF16Kind && in_kind == kInBF16) LDPC_LAUNCH(kMsgBF16Kind, __nv_bfloat16);
#undef LDPC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace oai5g
