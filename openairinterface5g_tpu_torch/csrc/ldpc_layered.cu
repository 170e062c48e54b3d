// K1, row-layered schedule: normalized min-sum LDPC decoder for NR base
// graphs 1 and 2 (TS 38.212 §5.3.2), with a per-code-block early stop.
//
// Replaces the Pallas kernel openairinterface5g_tpu/ops/ldpc_pallas.py::
// _build_decoder in the layered variants decode_pallas reaches it with:
// f32 messages (f32 totals) with f32 or bf16 input, and int8 messages
// (int32 totals, ±127 saturation, alpha = 13/16 in integers) with int32
// pre-quantized input; early stop every `check_every` iterations.  (The
// flooding variants are csrc/ldpc_decoder.cu, bf16 layered is K2.)
//
// Arithmetic (csrc/ldpc_arith.cuh), per row r and check node k, for each
// edge d = (c, s) of r, in the order of ldpc_pallas.py:225-275:
//   v_d = total[c][(k + s) % Z] - c2v_old_d,
//   m1/m2 over the row's |v|, neg = XOR of the row's (v < 0),
//   c2v_new_d = sat(±scale(|v_d| == m1 ? m2 : m1)), sign neg ^ (v_d < 0),
//   total[c][(k + s) % Z] = t + (c2v_new_d - c2v_old_d).
// So the hard bits and flags equal the plain PyTorch version's
// (ops/ldpc_decoder.py::decode_plain) and the Pallas kernel's bit for bit.
//
// What bounds it on an H100.  Not bytes: the LLRs are read once and the
// bits written once.  A layered decode is a chain of dependent layers, each
// ending in a block-wide barrier, so the time is the layers' latency and
// the issue of their operations on the SM.  One BG1 code block at Z = 384
// would have 316 x 384 f32 messages (474 KiB), more than the 227 KB of
// shared memory beside its 104 KB of totals; kept as messages in device
// memory they are 101 MB at 208 code blocks (twice the 50 MB L2), zero-
// filled, read and written every layer after the barrier.
//
// Design.
//  * Compressed check-node state, not messages.  Per (row, lane) the
//    kernel keeps s1 = sat(scale(m1)), s2 = sat(scale(m2)), and one word:
//    the outgoing messages' signs (bit d) and d*, the first edge whose
//    |v| equals m1 (bits 19-23).  The message to edge d is then
//    ±(d == d* ? s2 : s1), exactly the value above: an edge d != d* with
//    |v_d| == m1 means m1 is taken twice, so m2 == m1; the stored sign
//    bit gives back -0.0 where the update made it.  12 B per (row, lane):
//    212 KB per BG1 Z=384 code block, 44 MB at 208, which stays in the
//    L2.  Zero messages are the state (0, 0, any d*, no signs), so the
//    first iteration reads no state and nothing is zero-filled.
//  * Merged orthogonal rows.  A host table groups consecutive rows that
//    share no column into one layer (BG1: 46 rows in 32 layers, BG2: 42
//    in 28): their updates touch disjoint totals, so one barrier per layer
//    changes no bit.
//  * The state of the next layer is loaded before the barrier.  A thread's
//    state for a row is its own, written one iteration earlier, and does
//    not depend on this layer's totals, so the load overlaps the barrier.
//  * The graph in shared memory: per layer (first row, rows), per row
//    (first edge, degree), per edge (col * Z, shift), about 1.6 KB for
//    BG1, read by every thread at the same address (a broadcast).
//  * The syndrome check, where Z is a multiple of 32, works on the
//    totals' signs packed 32 lanes to a word (a ballot per warp and
//    column, then funnel shifts: any_check_fails_packed); else it walks
//    each row's edges.  A check of the final totals is reused for the
//    `ok` flag.
//  * One thread block per code block, Z threads, thread k is check node k
//    of every row; the totals live in dynamic shared memory (104 KB at
//    BG1 Z=384, two blocks per SM).  The early stop is per code block:
//    after every `check_every`-th iteration a block-wide check
//    (__syncthreads_or) ends that block's decode alone.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "ldpc_arith.cuh"

namespace {

using namespace oai5g;

constexpr int kMaxDeg = 19;      // largest check-node degree of BG1 (BG2: 10)
constexpr int kMaxZ = 384;       // largest lifting size: one thread per lane
constexpr int kMaxRows = 3;      // rows in one layer (BG1: 2, BG2: 3)
constexpr int kDstarShift = kMaxDeg;          // d* above the sign bits
constexpr unsigned kSignMask = (1u << kMaxDeg) - 1;

template <typename Acc> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<int> { using type = int2; };

// The check-node state of one (row, lane).
template <typename Acc> struct State {
  Acc s1, s2;     // sat(scale(m1)), sat(scale(m2))
  unsigned w;     // outgoing signs (bit d) | d* << kDstarShift
};

template <typename Acc>
__device__ __forceinline__ State<Acc> load_state(const typename Vec2<Acc>::type* mag,
                                                 const unsigned* w, int i) {
  const auto m = __ldcg(mag + i);
  return {m.x, m.y, __ldcg(w + i)};
}

template <typename Acc>
__device__ __forceinline__ void store_state(typename Vec2<Acc>::type* mag, unsigned* w,
                                            int i, const State<Acc>& s) {
  typename Vec2<Acc>::type m;
  m.x = s.s1;
  m.y = s.s2;
  __stcg(mag + i, m);
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

// One row's update at lane k: reads the totals of its D edges and the old
// state, writes the totals and returns the new state.
// kFirst: the first iteration, every old message +0.0 (t - 0 == t and
// nv - 0 == nv exactly).
//
// d* is the first edge with the least |v|.  The message to edge d is
// ±scale(|v_d| == m1 ? m2 : m1), and (d == d* ? m2 : m1) is the same
// value: another edge with |v_d| == m1 means m1 is taken twice, so
// m2 == m1.  So the second pass needs no v.  The second pass reads each
// total again (in this layer no other thread writes it) and, for rows of
// degree up to 10, takes the edges' positions from the first, two 16-bit
// positions to a register; the 19-edge rows compute them again, which
// keeps the registers under the two-blocks-per-SM cap without spilling.
template <int M, bool kFirst, int D>
__device__ __forceinline__ State<typename Arith<M>::acc> row_update_d(
    typename Arith<M>::acc* tot, const int* etab, int e0, int k, int Z, float alpha,
    const State<typename Arith<M>::acc>& old) {
  using A = Arith<M>;
  using Acc = typename A::acc;
  constexpr bool kKeepPos = D <= 10;
  unsigned pk[kKeepPos ? (D + 1) / 2 : 1];
  Acc m1 = A::kBig, m2 = A::kBig;
  unsigned neg = 0, dstar = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int pos = edge_pos(etab[e0 + d], k, Z);
    if (kKeepPos) pk[d / 2] = d % 2 ? pk[d / 2] | (unsigned)pos << 16 : (unsigned)pos;
    const Acc t = tot[pos];
    const Acc v = kFirst ? t : A::sub(t, message<A>(old, d));
    const Acc a = A::absv(v);
    dstar = a < m1 ? d : dstar;
    m2 = min(m2, max(m1, a));
    m1 = min(m1, a);
    neg |= (unsigned)(v < 0) << d;
  }
  const unsigned sgn = (__popc(neg) & 1) ? neg ^ kSignMask : neg;
  const Acc s1 = A::sat(A::scale(m1, alpha));
  const Acc s2 = A::sat(A::scale(m2, alpha));
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int pos = kKeepPos ? (int)(d % 2 ? pk[d / 2] >> 16 : pk[d / 2] & 0xFFFFu)
                             : edge_pos(etab[e0 + d], k, Z);
    const Acc t = tot[pos];
    const Acc nv = A::with_sign(d == (int)dstar ? s2 : s1, (sgn >> d) & 1u);
    tot[pos] = kFirst ? A::add(t, nv) : A::add(t, A::sub(nv, message<A>(old, d)));
  }
  return {s1, s2, (sgn & kSignMask) | (dstar << kDstarShift)};
}

// A row's update, unrolled to its exact degree: the NR base graphs have
// rows of degree 3 to 10 and 19 (BG1 rows 0-3; the wrapper's table holds
// no other), and a guarded loop over kMaxDeg would issue all 19 slots'
// instructions, predicated off, for every row.
template <int M, bool kFirst>
__device__ __forceinline__ State<typename Arith<M>::acc> row_update(
    typename Arith<M>::acc* tot, const int* etab, int rinfo, int k, int Z, float alpha,
    const State<typename Arith<M>::acc>& old) {
  const int e0 = rinfo & 0xFFFF;
  const int deg = rinfo >> 16;
#define ROW_CASE(D) \
  case D: return row_update_d<M, kFirst, D>(tot, etab, e0, k, Z, alpha, old);
  switch (deg) {
    ROW_CASE(3) ROW_CASE(4) ROW_CASE(5) ROW_CASE(6) ROW_CASE(7) ROW_CASE(8)
    ROW_CASE(9) ROW_CASE(10)
    default:  // 19
      return row_update_d<M, kFirst, kMaxDeg>(tot, etab, e0, k, Z, alpha, old);
  }
#undef ROW_CASE
}

// One iteration over every layer.  `nxt` holds the state of the first
// layer's rows on entry (unused when kFirst) and, where `prefetch_next`,
// the next iteration's on exit.
template <int M, bool kFirst>
__device__ __forceinline__ void iteration(
    typename Arith<M>::acc* tot, const int* lay, const int* rtab, const int* etab,
    typename Vec2<typename Arith<M>::acc>::type* mag, unsigned* word, int layers, int k,
    int Z, float alpha, State<typename Arith<M>::acc> (&nxt)[kMaxRows], bool prefetch_next) {
  using S = State<typename Arith<M>::acc>;
  for (int l = 0; l < layers; ++l) {
    const int li = lay[l];
    const int r0 = li & 0xFFFF;
    const int nr = li >> 16;
    S cur[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) cur[j] = nxt[j];
#pragma unroll 1
    for (int j = 0; j < nr; ++j) {
      const int r = r0 + j;
      store_state(mag, word, r * Z + k,
                  row_update<M, kFirst>(tot, etab, rtab[r], k, Z, alpha, cur[0]));
#pragma unroll
      for (int i = 0; i + 1 < kMaxRows; ++i) cur[i] = cur[i + 1];
    }
    // the next layer's state, before the barrier
    const bool last = l + 1 == layers;
    if (last ? prefetch_next : !kFirst) {
      const int ln = lay[last ? 0 : l + 1];
      const int rn = ln & 0xFFFF;
      const int nn = ln >> 16;
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j)
        if (j < nn) nxt[j] = load_state<typename Arith<M>::acc>(mag, word, (rn + j) * Z + k);
    }
    __syncthreads();
  }
}

// The parity of the D-edge row from edge e0 at lane k: XOR of its totals'
// (t < 0).
template <int D, typename Acc>
__device__ __forceinline__ int row_parity_d(const Acc* tot, const int* etab, int e0, int k,
                                            int Z) {
  int par = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) par ^= tot[edge_pos(etab[e0 + d], k, Z)] < 0;
  return par;
}

// 1 in every thread if any parity check of the code block fails; each row
// unrolled to its exact degree, as in row_update.
template <typename Acc>
__device__ int any_check_fails(const Acc* tot, const int* rtab, const int* etab, int rows,
                               int k, int Z) {
  int bad = 0;
  for (int r = 0; r < rows; ++r) {
    const int ri = rtab[r];
    const int e0 = ri & 0xFFFF;
    const int deg = ri >> 16;
#define CHECK_CASE(D) \
  case D: bad |= row_parity_d<D>(tot, etab, e0, k, Z); break;
    switch (deg) {
      CHECK_CASE(3) CHECK_CASE(4) CHECK_CASE(5) CHECK_CASE(6) CHECK_CASE(7) CHECK_CASE(8)
      CHECK_CASE(9) CHECK_CASE(10)
      default: bad |= row_parity_d<kMaxDeg>(tot, etab, e0, k, Z);   // 19
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
template <typename Acc>
__device__ int any_check_fails_packed(const Acc* tot, unsigned* hard, const int* rtab,
                                      const int* etab, int rows, int cols, int k, int Z) {
  const int nw = Z >> 5;
  for (int c = 0; c < cols; ++c) {
    const unsigned m = __ballot_sync(0xffffffffu, tot[c * Z + k] < 0);
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

// The code block's LLRs into the totals: 16-byte loads, kFillLoads of
// them in flight per thread, where the block's LLRs are whole aligned
// 16-byte words (cols * Z a multiple of 8 for bf16 input, of 4 for f32
// and int32, as at Z = 384); else one value per load.
constexpr int kFillLoads = 8;

__device__ __forceinline__ void unpack(const uint4& w, float* dst, const float*) {
  dst[0] = __uint_as_float(w.x); dst[1] = __uint_as_float(w.y);
  dst[2] = __uint_as_float(w.z); dst[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, int* dst, const int*) {
  dst[0] = (int)w.x; dst[1] = (int)w.y; dst[2] = (int)w.z; dst[3] = (int)w.w;
}
__device__ __forceinline__ void unpack(const uint4& w, float* dst, const __nv_bfloat16*) {
  const unsigned v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // bf16 -> f32 is exact: the bits, shifted
    dst[2 * i] = __uint_as_float(v[i] << 16);
    dst[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
  }
}

template <typename T, typename Acc>
__device__ __forceinline__ void fill_totals(Acc* tot, const T* src, int n, int k, int nt) {
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    const int nv = n / V;
    for (int base = k; base < nv; base += kFillLoads * nt) {
      uint4 w[kFillLoads];
#pragma unroll
      for (int u = 0; u < kFillLoads; ++u)
        if (base + u * nt < nv) w[u] = __ldcs(s + base + u * nt);
#pragma unroll
      for (int u = 0; u < kFillLoads; ++u)
        if (base + u * nt < nv) unpack(w[u], tot + (size_t)(base + u * nt) * V, src);
    }
  } else {
    for (int i = k; i < n; i += nt) tot[i] = load_llr(src, i);
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kMaxZ, 2)
ldpc_layered_kernel(const T* __restrict__ llr, int8_t* __restrict__ bits,
                    uint8_t* __restrict__ ok,
                    typename Vec2<typename Arith<M>::acc>::type* __restrict__ mags,
                    unsigned* __restrict__ words, const int* __restrict__ tables,
                    int layers, int rows, int cols, int E, int Z, int K, int n_iters,
                    int check_every, float alpha) {
  using Acc = typename Arith<M>::acc;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* tot = reinterpret_cast<Acc*>(smem);               // (cols, Z) natural orientation
  int* lay = reinterpret_cast<int*>(tot + cols * Z);     // (layers,) then rows, then edges
  const int* rtab = lay + layers;
  const int* etab = rtab + rows;
  unsigned* hard = reinterpret_cast<unsigned*>(lay + layers + rows + E);  // (cols, Z/32)
  const bool packed = (Z & 31) == 0;
  const int b = blockIdx.x;
  const int k = threadIdx.x;                              // blockDim.x == Z
  const T* llr_b = llr + (size_t)b * cols * Z;
  auto* mag = mags + (size_t)b * rows * Z;
  unsigned* word = words + (size_t)b * rows * Z;

  for (int i = k; i < layers + rows + E; i += Z) lay[i] = tables[i];
  fill_totals(tot, llr_b, cols * Z, k, Z);
  __syncthreads();

  State<Acc> nxt[kMaxRows] = {};
  int bad = -1;          // the flag of a check of the current totals; -1: none yet
  for (int it = 0; it < n_iters; ++it) {
    if (it == 0)
      iteration<M, true>(tot, lay, rtab, etab, mag, word, layers, k, Z, alpha, nxt,
                         n_iters > 1);
    else
      iteration<M, false>(tot, lay, rtab, etab, mag, word, layers, k, Z, alpha, nxt,
                          it + 1 < n_iters);
    bad = -1;
    if (check_every > 0 && it % check_every == check_every - 1) {
      bad = packed ? any_check_fails_packed(tot, hard, rtab, etab, rows, cols, k, Z)
                   : any_check_fails(tot, rtab, etab, rows, k, Z);
      if (!bad) break;   // uniform: __syncthreads_or gives every thread the same value
    }
  }
  for (int c = 0; c < K / Z; ++c)
    bits[(size_t)b * K + c * Z + k] = tot[c * Z + k] < 0;
  if (bad < 0)
    bad = packed ? any_check_fails_packed(tot, hard, rtab, etab, rows, cols, k, Z)
                 : any_check_fails(tot, rtab, etab, rows, k, Z);
  if (k == 0) ok[b] = !bad;
}

template <int M, typename T>
int launch(const void* llr, void* bits, void* ok, void* state, const void* tables, int B,
           int layers, int rows, int cols, int E, int Z, int K, int n_iters,
           int check_every, float alpha, int device, cudaStream_t stream) {
  using Acc = typename Arith<M>::acc;
  using V2 = typename Vec2<Acc>::type;
  const int smem = cols * Z * (int)sizeof(Acc) + (layers + rows + E) * (int)sizeof(int) +
                   ((Z & 31) == 0 ? cols * (Z >> 5) * (int)sizeof(unsigned) : 0);
  auto kernel = ldpc_layered_kernel<M, T>;
  static SmemLimit limit;
  const cudaError_t err = limit.reserve(reinterpret_cast<const void*>(kernel), device, smem);
  if (err != cudaSuccess) return (int)err;
  V2* mags = static_cast<V2*>(state);
  unsigned* words = reinterpret_cast<unsigned*>(mags + (size_t)B * rows * Z);
  kernel<<<B, Z, smem, stream>>>(static_cast<const T*>(llr), static_cast<int8_t*>(bits),
                                 static_cast<uint8_t*>(ok), mags, words,
                                 static_cast<const int*>(tables), layers, rows, cols, E, Z,
                                 K, n_iters, check_every, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// llr (B, cols*Z) -> bits (B, K) int8, ok (B,) bool, under the row-layered
// schedule.  in_kind: 0 f32, 1 bf16, 2 int32; msg_kind: 0 f32, 1 int8 (f32
// messages take f32 or bf16 input, int8 messages int32 input).
// state: scratch of 12 * B * rows * Z bytes, 8-byte aligned, never read
// before the kernel writes it.  tables: int32, `layers` words (first row |
// rows << 16), then `rows` words (first edge | degree << 16), then E words
// (col * Z | shift << 16), rows in order and each row's edges in column
// order; every row's degree 3 to 10 or 19, as in the NR base graphs.  All
// tensors on CUDA device `device`.
extern "C" int ldpc_layered_decode(const void* llr, int in_kind, int msg_kind, void* bits,
                                   void* ok, void* state, const void* tables, int B,
                                   int layers, int rows, int cols, int E, int Z, int K,
                                   int n_iters, int check_every, float alpha, int device,
                                   void* stream) {
  if (B == 0) return 0;
  if (Z > kMaxZ) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDPC_LAUNCH(M, T)                                                               \
  return launch<M, T>(llr, bits, ok, state, tables, B, layers, rows, cols, E, Z, K,    \
                      n_iters, check_every, alpha, device, s)
  if (msg_kind == kMsgF32 && in_kind == kInF32) LDPC_LAUNCH(kMsgF32, float);
  if (msg_kind == kMsgF32 && in_kind == kInBF16) LDPC_LAUNCH(kMsgF32, __nv_bfloat16);
  if (msg_kind == kMsgI8 && in_kind == kInI32) LDPC_LAUNCH(kMsgI8, int);
#undef LDPC_LAUNCH
  return (int)cudaErrorInvalidValue;
}
