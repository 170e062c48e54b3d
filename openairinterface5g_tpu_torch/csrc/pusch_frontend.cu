// K3: fused PUSCH frontend.  DMRS channel estimation, MRC or 2x2 MMSE,
// max-log LLRs and descrambling, written straight into the e-domain bit
// planes (B, qm, G/qm) that rate recovery slices.
//
// Replaces the Pallas kernel openairinterface5g_tpu/ops/pusch_frontend_pallas.py::
// _build on the configurations its `supported` accepts: CP-OFDM,
// single-symbol type-1 DMRS at any number of positions, 1 or 2 layers on
// one CDM group, window channel estimation, Qm in {2, 4, 6, 8}.
//
// What bounds it on an H100.  The work is a few flops per byte: reading the
// RE grid and writing the LLR planes once each (16.8 MB for the 8-slot
// 273-PRB 2x2 batch, 5 us at 3.35 TB/s).  The estimate is a chain of small
// dependent steps (LS, CDM split, moving average, interpolation) and the
// 2-layer noise variance is one sum over the whole slot, so a design that
// runs the estimate on one SM per slot, or hands the estimate to a second
// launch through device memory, is latency-bound far above the byte bound.
//
// Design: one launch, grid (C, B), one thread-block cluster of C blocks per
// slot.  Block t of a cluster owns subcarriers [m0, m1) of its slot, edges on
// multiples of 4 so that a CDM pair (two pilots) never straddles two tiles.
// A block is 8 compute warps and one producer warp:
//   1. the producer issues 1-D bulk asynchronous copies (cp.async.bulk,
//      completion on mbarriers): the DMRS rows and pilots over the tile plus
//      a halo (the window and the interpolation neighbour, in whole pairs;
//      replicate padding clamps at the allocation's edges, not the tile's),
//      then, once those have arrived, the data rows and packed scrambling
//      signs of the tile, on a second barrier.  A warp that issues bulk
//      copies can stall until the memory system takes them, so the compute
//      warps issue none;
//   2. the compute warps estimate the tile in shared memory: LS averaged
//      over the DMRS symbols, the (+1, -1) CDM split, the moving average,
//      then per subcarrier the comb-2 interpolation, kept as conj(h) per
//      antenna and layer, and the gain (1 layer) or the Gram matrix
//      (2 layers); h never leaves the SM;
//   3. the 2-layer noise variance: each block sums the pair-difference
//      terms whose left pair it owns and stores the partial into every
//      block of the cluster (st.async into distributed shared memory,
//      completing on the receiver's mbarrier), so every block adds the same
//      C partials in rank order: no atomics, no fence, and one cluster
//      barrier, at the start, that orders the barriers' initialisation
//      before the stores.  1 layer (MRC) needs no nvar and no cluster sync;
//   4. from shared memory, the matched filter x_l = sum_r conj(h_lr) y_r,
//      then MRC or the closed-form 2x2 MMSE (per subcarrier three
//      coefficients from the Gram matrix and nvar), the LLRs and the
//      descrambling, two subcarriers a thread at a time in 16-byte loads;
//      each plane takes one 16-byte store per subcarrier pair at 2 layers.
//      The kernel is a template on (layers, Qm).
// Shared memory does not grow with the antennas or the DMRS symbols: the
// antennas go in groups of r_grp (all of them where they fit, as on the
// main path), each group through the same buffers; the noise terms, the
// Gram matrix and, with more than one group, x are summed over the groups,
// and the last group equalizes.  The data rows of a group are staged s_buf
// symbols at a time, all of them where shared memory allows.
// The TPU kernel's lane rolls, masked log-doubling cumsum and (16, mpad)
// padding answered TPU gather costs; here the halo is plain indexing.
//
// ops/pusch_frontend.py plans a launch once per configuration and device:
// C, r_grp, s_buf and the tiles' caps (shape_of, planned_cluster), with the
// card's cudaOccupancyMaxActiveClusters through pusch_frontend_clusters.
// The launch refuses caps or shared memory short of what the tiles and
// the layout need.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCompute = 256;                // threads of the compute warps
constexpr int kThreads = kCompute + 32;      // and one producer warp
constexpr int kMaxCluster = 16;              // non-portable above 8
// Two blocks per SM at least: without the bound the antenna-group loop's
// live state took registers enough for one block per SM, too few
// clusters of 16 stayed resident, and an 8-slot batch ran in two waves.
constexpr int kMinBlocks = 2;

// a * conj(b)
__device__ __forceinline__ float2 mul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// a * b
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 scale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }

__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

// The tile of block t of C over an allocation of n_pil pilots (M = 2 n_pil
// subcarriers, n_pil / 2 CDM pairs): its subcarriers [m0, m1), the pilots
// whose smoothed estimate it interpolates from [h_lo, h_hi], and the pilots
// it loads [lo, hi), whole pairs.  ops/pusch_frontend.py::tile_of is the
// same plan in Python.
struct Tile {
  int m0, m1, h_lo, h_hi, lo, hi;
};

__host__ __device__ __forceinline__ Tile tile_of(int t, int C, int n_pil, int window) {
  const int n_q = n_pil / 2;
  const int q0 = (int)((long long)t * n_q / C), q1 = (int)((long long)(t + 1) * n_q / C);
  const int pad_l = window > 1 ? window / 2 : 0;
  const int pad_r = window > 1 ? window - 1 - window / 2 : 0;
  Tile x;
  x.m0 = 4 * q0;
  x.m1 = 4 * q1;
  x.h_lo = 2 * q0 > 0 ? 2 * q0 - 1 : 0;
  x.h_hi = 2 * q1 < n_pil - 1 ? 2 * q1 : n_pil - 1;
  x.lo = (x.h_lo - pad_l > 0 ? x.h_lo - pad_l : 0) & ~1;
  x.hi = ((x.h_hi + pad_r < n_pil - 1 ? x.h_hi + pad_r : n_pil - 1) | 1) + 1;
  return x;
}

struct Args {
  const float2* y;          // (B, R, n_sym, n_sc)
  const float2* pilots;     // (n_dmrs, n_pil), DMRS symbols in ascending order
  const uint32_t* signs;    // (n_data * M,): bit l*qm + j scrambles bit j of layer l
  float* planes;            // (B, qm, n_data * M * P)
  int R, n_sym, n_sc, a0, n_pil, delta, n_dmrs, n_data, window;
  int dmrs_mask, data_mask; // bit s set: symbol s carries DMRS / data
  int r_grp;                // antennas per group: the estimate and the matched filter
                            // take one group at a time
  int s_buf;                // data symbols staged per round
  int tile_cap, ls_cap, hs_cap;   // the widest tile's subcarriers, loaded and smoothed pilots
};

// The parts of a block's dynamic shared memory, byte offsets.  Each is a
// multiple of 16 bytes (tile_cap is a multiple of 4, ls_cap and hs_cap are
// even), and none grows with R or the DMRS symbols beyond one group of
// r_grp antennas.  ops/pusch_frontend.py::smem_bytes sizes the same parts.
struct Layout {
  unsigned ydat, sg, ydm, pil, ls, pr, hs, hc, xs, mag, coef, end;
};

__host__ __device__ inline Layout layout_of(const Args& a, int P) {
  const unsigned f2 = sizeof(float2), cap = a.tile_cap, G = a.r_grp;
  Layout l;
  l.ydat = 0;                                          // (s_buf, r_grp, cap) data rows
  l.sg = l.ydat + f2 * a.s_buf * G * cap;              // (s_buf, cap) packed signs
  l.ydm = l.sg + 4u * a.s_buf * cap;                   // (r_grp, n_dmrs, 2 ls_cap) DMRS rows
  l.pil = l.ydm + f2 * G * a.n_dmrs * 2 * a.ls_cap;    // (n_dmrs, ls_cap) pilots
  l.ls = l.pil + f2 * a.n_dmrs * a.ls_cap;             // (r_grp, ls_cap) LS
  l.pr = l.ls + f2 * G * a.ls_cap;                     // 2 layers: (r_grp, 2, ls_cap / 2)
  l.hs = l.pr + (P == 2 ? f2 * G * a.ls_cap : 0u);     // (r_grp, P, hs_cap) smoothed
  l.hc = l.hs + f2 * G * P * a.hs_cap;                 // (P, r_grp, cap) conj(h)
  l.xs = l.hc + f2 * P * G * cap;                      // groups > 1: (n_data, P, cap) x
  l.mag = l.xs + (a.r_grp < a.R ? f2 * a.n_data * P * cap : 0u);   // (P, cap) gains
  l.coef = l.mag + 4u * P * cap;                       // 2 layers: (cap,) float4 Gram, MMSE
  l.end = l.coef + (P == 2 ? 16u * cap : 0u);
  return l;
}


__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The cluster barrier, taken by every thread of every block, converged
__device__ __forceinline__ void cluster_arrive_relaxed() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// index of the n-th set bit of mask (n from 0)
__device__ __forceinline__ int nth_bit(uint32_t mask, int n) {
  for (int i = 0; i < n; ++i) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// The bulk copies of the DMRS rows of antennas [r0, r0 + rg) over the
// tile's pilots [lo, hi) into row (r, d) of ydm, and with `pilots` those
// pilots into pil, on `bar`, shared by the lanes of one warp.
__device__ __forceinline__ void issue_dmrs(const Args& a, int b, const Tile& t, int r0, int rg,
                                           bool pilots, float2* ydm, float2* pil,
                                           uint64_t* bar, int lane) {
  const uint32_t row = (uint32_t)((t.hi - t.lo) * sizeof(float2));
  const int n = (rg + (pilots ? 1 : 0)) * a.n_dmrs;
  if (lane == 0) expect_tx(bar, (uint32_t)(rg * 2 + (pilots ? 1 : 0)) * a.n_dmrs * row);
  __syncwarp();
  for (int c = lane; c < n; c += 32) {
    const int r = c / a.n_dmrs, d = c - r * a.n_dmrs;
    if (r < rg) {
      const int s = nth_bit((uint32_t)a.dmrs_mask, d);
      bulk_copy(ydm + (size_t)c * 2 * a.ls_cap,
                a.y + ((size_t)(b * a.R + r0 + r) * a.n_sym + s) * a.n_sc + a.a0 + 2 * t.lo,
                2 * row, bar);
    } else {
      bulk_copy(pil + (size_t)d * a.ls_cap, a.pilots + (size_t)d * a.n_pil + t.lo, row, bar);
    }
  }
}

// The bulk copies of data symbols [s0, s0 + ns) of antennas [r0, r0 + rg)
// over the tile, on `bar`, shared by the lanes of one warp: the RE rows into
// row (k, r) of the staging ydat and, with `signs` (the last group), the
// packed scrambling signs into row k of sg.
__device__ __forceinline__ void issue_data(const Args& a, int b, const Tile& t, int r0, int rg,
                                           bool signs, int s0, int ns, float2* ydat,
                                           uint32_t* sg, uint64_t* bar, int lane) {
  const int w = t.m1 - t.m0, M = 2 * a.n_pil, per = rg + (signs ? 1 : 0);
  if (lane == 0)
    expect_tx(bar, (uint32_t)(ns * w * (rg * sizeof(float2) + (signs ? sizeof(uint32_t) : 0))));
  __syncwarp();
  for (int c = lane; c < ns * per; c += 32) {
    const int k = c / per, r = c - k * per;
    if (r == rg) {
      bulk_copy(sg + (size_t)k * a.tile_cap, a.signs + (size_t)(s0 + k) * M + t.m0,
                (uint32_t)(w * sizeof(uint32_t)), bar);
      continue;
    }
    const int s = nth_bit((uint32_t)a.data_mask, s0 + k);
    bulk_copy(ydat + ((size_t)k * a.r_grp + r) * a.tile_cap,
              a.y + ((size_t)(b * a.R + r0 + r) * a.n_sym + s) * a.n_sc + a.a0 + t.m0,
              (uint32_t)(w * sizeof(float2)), bar);
  }
}


// The barrier of the compute warps (named barrier 1): the producer warp
// takes no part in it
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kCompute) : "memory");
}

// The QM max-log LLRs of one compensated symbol x with gain mag; llr.py's
// order.
template <int QM>
__device__ __forceinline__ void llr_bits(float2 x, float mag, float* o) {
  o[0] = x.x;
  o[1] = x.y;
  if constexpr (QM == 2) {
    o[0] *= 0.70710678118654752f;
    o[1] *= 0.70710678118654752f;
  } else if constexpr (QM == 4) {
    const float t = 2.f * 0.31622776601683794f * mag;
    o[2] = t - fabsf(x.x);
    o[3] = t - fabsf(x.y);
  } else if constexpr (QM == 6) {
    const float s = 0.15430334996209191f;
    const float t4 = 4.f * s * mag, t2 = 2.f * s * mag;
    o[2] = t4 - fabsf(x.x);
    o[3] = t4 - fabsf(x.y);
    o[4] = t2 - fabsf(o[2]);
    o[5] = t2 - fabsf(o[3]);
  } else {
    static_assert(QM == 8, "Qm is 2, 4, 6 or 8");
    const float s = 0.07669649888473704f;
    const float t8 = 8.f * s * mag, t4 = 4.f * s * mag, t2 = 2.f * s * mag;
    o[2] = t8 - fabsf(x.x);
    o[3] = t8 - fabsf(x.y);
    o[4] = t4 - fabsf(o[2]);
    o[5] = t4 - fabsf(o[3]);
    o[6] = t2 - fabsf(o[4]);
    o[7] = t2 - fabsf(o[5]);
  }
}

// v with its sign flipped where `bit` is 1 (v * (1 - 2 c), exactly)
__device__ __forceinline__ float flip(float v, uint32_t bit) {
  return __uint_as_float(__float_as_uint(v) ^ (bit << 31));
}

// Comb-2 interpolation at subcarrier m of the smoothed estimate hs, held
// for pilots [h_lo, ...]: the comb value, or the mean of the neighbours
// with a hold at the top edge (delta 0) or the bottom edge (delta 1).
__device__ __forceinline__ float2 interp(const float2* hs, int m, int h_lo, int delta,
                                         int n_pil) {
  if (((m - delta) & 1) == 0) return hs[((m - delta) >> 1) - h_lo];
  const int k = m >> 1;
  if (delta == 0) return scale(add(hs[k - h_lo], hs[min(k + 1, n_pil - 1) - h_lo]), 0.5f);
  if (k == 0) return hs[-h_lo];
  return scale(add(hs[k - 1 - h_lo], hs[k - h_lo]), 0.5f);
}

template <int P, int QM>
__global__ void __launch_bounds__(kThreads, kMinBlocks) frontend_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 0: DMRS rows and pilots; 1: the nvar partials; 2: the data rows
  __shared__ __align__(8) uint64_t bar[3];
  __shared__ float parts[kMaxCluster];       // 2 layers: every block's share of the nvar sum
  __shared__ float red[kCompute / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int R = a.R, n_pil = a.n_pil, n_dmrs = a.n_dmrs, cap = a.tile_cap, G = a.r_grp;
  const int n_grp = (R + G - 1) / G;
  const Tile t = tile_of(rank, C, n_pil, a.window);
  const int w = t.m1 - t.m0, n_ls = t.hi - t.lo, n_hs = t.h_hi - t.h_lo + 1;
  const int half = a.ls_cap / 2;

  const Layout L = layout_of(a, P);
  float2* ydat = reinterpret_cast<float2*>(smem_raw + L.ydat);
  uint32_t* sg = reinterpret_cast<uint32_t*>(smem_raw + L.sg);
  float2* ydm = reinterpret_cast<float2*>(smem_raw + L.ydm);
  float2* pil = reinterpret_cast<float2*>(smem_raw + L.pil);
  float2* ls = reinterpret_cast<float2*>(smem_raw + L.ls);
  float2* pr = reinterpret_cast<float2*>(smem_raw + L.pr);
  float2* hs = reinterpret_cast<float2*>(smem_raw + L.hs);
  float2* hc = reinterpret_cast<float2*>(smem_raw + L.hc);
  float2* xs = reinterpret_cast<float2*>(smem_raw + L.xs);
  float* mag = reinterpret_cast<float*>(smem_raw + L.mag);
  float4* coef = reinterpret_cast<float4*>(smem_raw + L.coef);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar[i])));
    if (P == 2) expect_tx(&bar[1], (uint32_t)(C * sizeof(float)));   // C partials to come
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  // 2 layers: the blocks send their partials once every block's barriers
  // are initialised
  if constexpr (P == 2) cluster_arrive_relaxed();

  if (tid >= kCompute) {
    // The producer warp: the first group's estimate loads, then, once they
    // have arrived, its first data symbols, which arrive while the compute
    // warps estimate.  A warp that issues bulk copies can stall until the
    // memory system takes them.
    const int rg = min(G, R);
    issue_dmrs(a, b, t, 0, rg, true, ydm, pil, &bar[0], lane);
    wait_phase(&bar[0], 0);
    issue_data(a, b, t, 0, rg, n_grp == 1, 0, min(a.s_buf, a.n_data), ydat, sg, &bar[2], lane);
    if constexpr (P == 2) cluster_wait();
    return;
  }

  const int pad_l = a.window > 1 ? a.window / 2 : 0;
  const int pad_r = a.window > 1 ? a.window - 1 - pad_l : 0;
  const int M = 2 * n_pil, plane_len = a.n_data * M * P, hw = w / 2;
  float* out = a.planes + (size_t)b * QM * plane_len;
  float acc = 0.f;          // 2 layers: this thread's share of the block's noise terms
  uint32_t round = 0;       // data rounds so far, over the groups: barrier 2's phase
  for (int g = 0; g < n_grp; ++g) {
    const int r0 = g * G, rg = min(G, R - r0);
    const bool last = g == n_grp - 1;
    if (g > 0) {   // the last group's buffers are free: this group's loads
      compute_sync();
      if (tid < 32) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_dmrs(a, b, t, r0, rg, false, ydm, pil, &bar[0], lane);
        issue_data(a, b, t, r0, rg, last, 0, min(a.s_buf, a.n_data), ydat, sg, &bar[2], lane);
      }
    }
    wait_phase(&bar[0], g & 1);

    // LS at the pilots [lo, hi), averaged over the DMRS symbols
    for (int it = tid; it < rg * n_ls; it += kCompute) {
      const int r = it / n_ls, i = it - r * n_ls;
      float2 s = make_float2(0.f, 0.f);
      for (int d = 0; d < n_dmrs; ++d)
        s = add(s, mul_conj(ydm[((size_t)r * n_dmrs + d) * 2 * a.ls_cap + 2 * i + a.delta],
                            pil[d * a.ls_cap + i]));
      ls[r * a.ls_cap + i] = make_float2(s.x / n_dmrs, s.y / n_dmrs);
    }
    compute_sync();

    if constexpr (P == 2) {
      // the frequency OCC (+1,+1) / (+1,-1) separates the ports; the noise
      // terms of the pairs [q0, q1) that have a right neighbour are this
      // block's share of nvar
      const int n_pair = n_pil / 2, q0 = t.m0 / 4, q1 = t.m1 / 4;
      for (int it = tid; it < rg * (n_ls / 2); it += kCompute) {
        const int r = it / (n_ls / 2), k = it - r * (n_ls / 2);
        const float2* l = ls + r * a.ls_cap + 2 * k;
        const float2 p0 = scale(add(l[0], l[1]), 0.5f), p1 = scale(sub(l[0], l[1]), 0.5f);
        pr[r * a.ls_cap + k] = p0;
        pr[r * a.ls_cap + half + k] = p1;
        const int q = t.lo / 2 + k;
        if (q >= q0 && q < q1 && q + 1 < n_pair) {
          const float2 e0 = scale(add(l[2], l[3]), 0.5f), e1 = scale(sub(l[2], l[3]), 0.5f);
          acc += abs2(sub(e0, p0)) + abs2(sub(e1, p1));
        }
      }
      if (last) {
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) red[tid >> 5] = acc;
        compute_sync();
        // warp 0 sends the partial to every block of the cluster: lane c
        // stores it asynchronously into block c's parts[rank], completing on
        // block c's barrier 1, so no fence and no second cluster barrier is
        // needed (the producer warp would send it late: it stalls on its
        // bulk copies)
        cluster_wait();
        if (tid < 32) {
          float v = lane < kCompute / 32 ? red[lane] : 0.f;
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane < C) {
            uint32_t dst, rbar;
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                         : "=r"(dst) : "r"(smem_addr(&parts[rank])), "r"(lane));
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                         : "=r"(rbar) : "r"(smem_addr(&bar[1])), "r"(lane));
            asm volatile(
                "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                :: "r"(dst), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
          }
        }
      }
    }

    // replicate-padded moving average at the pilots [h_lo, h_hi]
    for (int it = tid; it < rg * P * n_hs; it += kCompute) {
      const int rp = it / n_hs, jj = it - rp * n_hs;
      const int r = rp / P, p = rp - r * P;
      // 2 layers: pilot q holds its pair's value
      const float2* src =
          P == 1 ? ls + r * a.ls_cap - t.lo : pr + r * a.ls_cap + p * half - t.lo / 2;
      const int j = t.h_lo + jj;
      float2 s = make_float2(0.f, 0.f);
      for (int q = j - pad_l; q <= j + pad_r; ++q)
        s = add(s, src[min(max(q, 0), n_pil - 1) >> (P - 1)]);
      hs[rp * a.hs_cap + jj] = a.window > 1 ? make_float2(s.x / a.window, s.y / a.window) : s;
    }
    compute_sync();

    // per subcarrier of the tile, h of the group's antennas by interpolation,
    // kept as conj(h) for the matched filter, and the gain (1 layer) or the
    // Gram matrix (2 layers) summed over the groups; each thread keeps its
    // subcarriers over the groups
    for (int ml = tid; ml < w; ml += kCompute) {
      const int m = t.m0 + ml;
      float g00 = 0.f, g11 = 0.f;
      float2 g01 = make_float2(0.f, 0.f);
      for (int r = 0; r < rg; ++r) {
        const float2 h0 = interp(hs + r * P * a.hs_cap, m, t.h_lo, a.delta, n_pil);
        g00 += abs2(h0);
        hc[r * cap + ml] = make_float2(h0.x, -h0.y);
        if constexpr (P == 2) {
          const float2 h1 = interp(hs + (r * 2 + 1) * a.hs_cap, m, t.h_lo, a.delta, n_pil);
          g11 += abs2(h1);
          g01 = add(g01, mul_conj(h1, h0));   // conj(h0) * h1
          hc[(G + r) * cap + ml] = make_float2(h1.x, -h1.y);
        }
      }
      if constexpr (P == 1) {
        mag[ml] = (g > 0 ? mag[ml] : 0.f) + g00;
      } else {
        const float4 c = g > 0 ? coef[ml] : make_float4(0.f, 0.f, 0.f, 0.f);
        coef[ml] = make_float4(c.x + g00, c.y + g11, c.z + g01.x, c.w + g01.y);
      }
    }

    if constexpr (P == 2) {
      if (last) {
        // every block holds the same C partials and adds them in rank order
        wait_phase(&bar[1], 0);
        float v = 0.f;
        for (int c = 0; c < C; ++c) v += parts[c];
        const float nv = v * (float)n_dmrs / ((float)R * P * (n_pil / 2 - 1));
        // e0 = (a11 x0 - g01 x1) inv, e1 = (a00 x1 - conj(g01) x0) inv
        // (equalization.py::mmse_equalize_2layer): per subcarrier
        // (a11 inv, a00 inv, g01 inv) and the gains
        for (int ml = tid; ml < w; ml += kCompute) {
          const float4 c = coef[ml];
          const float a00 = c.x + nv, a11 = c.y + nv, ag2 = c.z * c.z + c.w * c.w;
          const float inv = 1.f / (a00 * a11 - ag2);
          coef[ml] = make_float4(a11 * inv, a00 * inv, c.z * inv, c.w * inv);
          mag[ml] = (a11 * c.x - ag2) * inv;
          mag[cap + ml] = (a00 * c.y - ag2) * inv;
        }
      }
    }
    compute_sync();

    // the matched filter x_p = sum_r conj(h_pr) y_r over the group's
    // antennas, added to the earlier groups' (xs); in the last group the
    // equalizer, LLRs and descrambling, bit j of (re, l) at
    // planes[b, j, re * P + l].  Each thread takes two subcarriers
    // (ml, ml + 1) of a data symbol k at a time, in 16-byte loads, and walks
    // the staging at a stride of kCompute pairs; a plane takes one 16-byte
    // store (2 layers) or 8-byte store (1 layer) per pair.
    int k = tid / hw, mp = tid - k * hw;
    for (int s0 = 0; s0 < a.n_data; s0 += a.s_buf, ++round) {
      const int ns = min(a.s_buf, a.n_data - s0);
      if (s0 > 0) {   // the staging is free again: the next symbols
        compute_sync();
        if (tid < 32) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_data(a, b, t, r0, rg, last, s0, ns, ydat, sg, &bar[2], lane);
        }
      }
      wait_phase(&bar[2], round & 1);
      while (k < ns) {
        const int ml = 2 * mp;
        float4* xk = reinterpret_cast<float4*>(xs + (size_t)(s0 + k) * P * cap + ml);
        float4 x[P];
#pragma unroll
        for (int p = 0; p < P; ++p)
          x[p] = g > 0 ? xk[p * cap / 2] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float2* yk = ydat + (size_t)k * G * cap + ml;
        for (int r = 0; r < rg; ++r) {
          const float4 yv = *reinterpret_cast<const float4*>(yk + r * cap);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float4 wv = *reinterpret_cast<const float4*>(hc + (p * G + r) * cap + ml);
            const float2 u = mul(make_float2(yv.x, yv.y), make_float2(wv.x, wv.y));
            const float2 v = mul(make_float2(yv.z, yv.w), make_float2(wv.z, wv.w));
            x[p] = make_float4(x[p].x + u.x, x[p].y + u.y, x[p].z + v.x, x[p].w + v.y);
          }
        }
        if (!last) {
#pragma unroll
          for (int p = 0; p < P; ++p) xk[p * cap / 2] = x[p];
        } else {
          // the compensated symbols of (ml, ml + 1): e[p][i]
          float2 e[P][2];
          if constexpr (P == 1) {
            e[0][0] = make_float2(x[0].x, x[0].y);
            e[0][1] = make_float2(x[0].z, x[0].w);
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float4 c = coef[ml + i];
              const float2 gi = make_float2(c.z, c.w);
              const float2 x0 = i ? make_float2(x[0].z, x[0].w) : make_float2(x[0].x, x[0].y);
              const float2 x1 = i ? make_float2(x[1].z, x[1].w) : make_float2(x[1].x, x[1].y);
              e[0][i] = sub(scale(x0, c.x), mul(gi, x1));
              e[1][i] = sub(scale(x1, c.y), mul(make_float2(gi.x, -gi.y), x0));
            }
          }
          const uint2 sgn = *reinterpret_cast<const uint2*>(sg + k * cap + ml);
          float o[2][P][QM];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float2 mg = *reinterpret_cast<const float2*>(mag + p * cap + ml);
            llr_bits<QM>(e[p][0], mg.x, o[0][p]);
            llr_bits<QM>(e[p][1], mg.y, o[1][p]);
          }
          const int re = (s0 + k) * M + t.m0 + ml;
#pragma unroll
          for (int j = 0; j < QM; ++j) {
            if constexpr (P == 1) {
              *reinterpret_cast<float2*>(out + j * plane_len + re) = make_float2(
                  flip(o[0][0][j], (sgn.x >> j) & 1u), flip(o[1][0][j], (sgn.y >> j) & 1u));
            } else {
              *reinterpret_cast<float4*>(out + j * plane_len + 2 * re) = make_float4(
                  flip(o[0][0][j], (sgn.x >> j) & 1u), flip(o[0][1][j], (sgn.x >> (QM + j)) & 1u),
                  flip(o[1][0][j], (sgn.y >> j) & 1u), flip(o[1][1][j], (sgn.y >> (QM + j)) & 1u));
            }
          }
        }
        for (mp += kCompute; mp >= hw; mp -= hw) ++k;   // the next pair, kCompute on
      }
      k -= ns;
    }
  }
}

// The kernel of (P, qm), and its index among the eight.
using Kernel = void (*)(Args);
constexpr Kernel kKernels[8] = {
    frontend_kernel<1, 2>, frontend_kernel<1, 4>, frontend_kernel<1, 6>, frontend_kernel<1, 8>,
    frontend_kernel<2, 2>, frontend_kernel<2, 4>, frontend_kernel<2, 6>, frontend_kernel<2, 8>};
oai5g::SmemLimit smem_limits[8];
oai5g::ClusterLimit cluster_limits[8];

int kernel_index(int P, int qm) {
  if ((P != 1 && P != 2) || (qm != 2 && qm != 4 && qm != 6 && qm != 8)) return -1;
  return (P - 1) * 4 + qm / 2 - 1;
}

// Lets kernel ki run clusters of C blocks with `smem` bytes of dynamic
// shared memory each on the current device.
cudaError_t prepare(int ki, int C, int smem, int device) {
  const void* kernel = reinterpret_cast<const void*>(kKernels[ki]);
  if (C > 8) {
    const cudaError_t err = cluster_limits[ki].allow(kernel, device);
    if (err != cudaSuccess) return err;
  }
  return smem_limits[ki].reserve(kernel, device, smem);
}

cudaLaunchConfig_t launch_config(int C, int B, int smem, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of C blocks with `smem` bytes of dynamic shared memory
// each the kernel of (P, qm) holds resident at once on `device`
// (cudaOccupancyMaxActiveClusters; 0 when none fits), written to *active.
// ops/pusch_frontend.py::_plan asks once per configuration and device.
extern "C" int pusch_frontend_clusters(int P, int qm, int C, int smem, void* active,
                                       int device, void* stream) {
  (void)stream;
  const oai5g::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int ki = kernel_index(P, qm);
  if (ki < 0 || C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(ki, C, smem, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(C, 1, smem, attr);
  err = cudaOccupancyMaxActiveClusters(static_cast<int*>(active), kKernels[ki], &cfg);
  return (int)err;
}

// y (B, R, n_sym, n_sc) complex64 -> planes (B, qm, n_data*12*n_prb*P) f32.
// pilots (n_dmrs, 6*n_prb) complex64 with the DMRS symbols in ascending
// order; signs (n_data*12*n_prb,) uint32, per RE the scrambling bits of its
// P*qm LLRs, bit l*qm + j for bit j of layer l; dmrs_mask / data_mask: bit s
// set where symbol s carries DMRS / data (ascending order).  The shape of
// the launch, from ops/pusch_frontend.py::shape_of: C blocks per cluster,
// r_grp antennas per group, s_buf data symbols per round, the caps of the
// tiles and smem bytes of dynamic shared memory (refused if the caps or
// smem are short of what the tiles and the layout need).  y and pilots
// 16-byte aligned.  All tensors on CUDA device `device`.
extern "C" int pusch_frontend(const void* y, const void* pilots, const void* signs,
                              void* planes, int B, int R, int P, int n_sym, int n_sc, int a0,
                              int n_prb, int delta, int n_dmrs, int n_data, int qm, int window,
                              int dmrs_mask, int data_mask, int C, int r_grp, int s_buf,
                              int tile_cap, int ls_cap, int hs_cap, int smem, int device,
                              void* stream) {
  if (B == 0) return 0;
  const oai5g::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int ki = kernel_index(P, qm), n_pil = 6 * n_prb;
  if (ki < 0 || C < 1 || C > kMaxCluster || r_grp < 1 || s_buf < 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < C; ++i) {
    const Tile x = tile_of(i, C, n_pil, window);
    if (x.m1 - x.m0 > tile_cap || x.hi - x.lo > ls_cap || x.h_hi - x.h_lo + 1 > hs_cap)
      return (int)cudaErrorInvalidValue;
  }
  const Args args{static_cast<const float2*>(y), static_cast<const float2*>(pilots),
                  static_cast<const uint32_t*>(signs), static_cast<float*>(planes),
                  R, n_sym, n_sc, a0, n_pil, delta, n_dmrs, n_data, window,
                  dmrs_mask, data_mask, r_grp, s_buf, tile_cap, ls_cap, hs_cap};
  if (layout_of(args, P).end > (unsigned)smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(ki, C, smem, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(C, B, smem, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, kKernels[ki], args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
