// K3: fused PUSCH frontend.  DMRS channel estimation, MRC or 2x2 MMSE,
// max-log LLRs and descrambling, written straight into the e-domain bit
// planes (B, qm, G/qm) that rate recovery slices.
//
// Replaces the Pallas kernel openairinterface5g_tpu/ops/pusch_frontend_pallas.py::
// _build on the configurations its `supported` accepts: CP-OFDM,
// single-symbol type-1 DMRS at any number of positions, 1 or 2 layers on
// one CDM group, window channel estimation, Qm in {2, 4, 6, 8}.
//
// What bounds it on an H100.  One 273-PRB slot with 2 antennas is
// 2 x 14 x 3276 complex64 (about 717 KiB), more than one block's shared
// memory, so the TPU's one-program-per-slot design does not transfer.  The
// work is a few flops per byte: the kernel is bound by reading the RE grid
// and writing the LLR planes once each.
//
// Design: two launches.
//   1. estimate_kernel, one block per slot: LS at the comb averaged over the
//      DMRS symbols, CDM pair separation for 2 layers, the noise variance
//      from pair differences, the replicate-padded moving average and the
//      comb-2 interpolation, one antenna at a time through shared memory.
//      Writes h (B, R, P, M) and nvar (B,).
//   2. equalize_llr_kernel, one thread per (slot, data symbol, subcarrier):
//      MRC or 2x2 MMSE, the LLRs, the descrambling sign, and each bit stored
//      at its final plane position (layer interleave included).
// The TPU kernel's lane rolls, masked log-doubling cumsum and (16, mpad)
// padding answered TPU gather costs; here strided reads are plain loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kEstThreads = 256;
constexpr int kEqThreads = 256;

// a * conj(b)
__device__ __forceinline__ float2 mul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

// y: (B, R, n_sym, n_sc) complex; pilots: (n_dmrs, n_pil) complex.
__global__ void __launch_bounds__(kEstThreads)
estimate_kernel(const float2* __restrict__ y, const float2* __restrict__ pilots,
                const int* __restrict__ dmrs_syms, float2* __restrict__ h,
                float* __restrict__ nvar, int R, int P, int n_sym, int n_sc,
                int a0, int n_pil, int delta, int n_dmrs, int window) {
  extern __shared__ float2 sm[];
  float2* ls = sm;                  // (n_pil,) LS averaged over DMRS symbols
  float2* hp = ls + n_pil;          // (P, n_pil) per-port comb values
  float2* hs = hp + P * n_pil;      // (P, n_pil) after the moving average
  __shared__ float red[kEstThreads / 32];

  const int b = blockIdx.x;
  const int M = 2 * n_pil;
  const int n_pair = n_pil / 2;
  const int pad_l = window / 2;
  const int pad_r = window - 1 - pad_l;
  float acc = 0.f;                  // this thread's share of the nvar sum

  for (int r = 0; r < R; ++r) {
    // pilot i of DMRS symbol d at y[b, r, dmrs_syms[d], a0 + delta + 2i]
    const float2* yr = y + (size_t)(b * R + r) * n_sym * n_sc + a0 + delta;
    for (int i = threadIdx.x; i < n_pil; i += blockDim.x) {
      float2 s = make_float2(0.f, 0.f);
      for (int d = 0; d < n_dmrs; ++d) {
        const float2* row = yr + (size_t)dmrs_syms[d] * n_sc;
        const float2 l = mul_conj(row[2 * i], pilots[d * n_pil + i]);
        s = add(s, l);
        if (P == 1 && i + 1 < n_pil) {  // 1 layer: nvar from adjacent pilots
          const float2 l1 = mul_conj(row[2 * i + 2], pilots[d * n_pil + i + 1]);
          acc += abs2(make_float2(l1.x - l.x, l1.y - l.y));
        }
      }
      ls[i] = make_float2(s.x / n_dmrs, s.y / n_dmrs);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n_pil; i += blockDim.x) {
      if (P == 1) {
        hp[i] = ls[i];
        continue;
      }
      // 2 layers: the frequency OCC (+1,+1) / (+1,-1) separates the ports
      const int k = i >> 1;
      const float2 e = ls[2 * k], o = ls[2 * k + 1];
      const float2 p0 = make_float2(0.5f * (e.x + o.x), 0.5f * (e.y + o.y));
      const float2 p1 = make_float2(0.5f * (e.x - o.x), 0.5f * (e.y - o.y));
      hp[i] = p0;
      hp[n_pil + i] = p1;
      if ((i & 1) == 0 && k + 1 < n_pair) {  // nvar from pair differences
        const float2 e2 = ls[2 * k + 2], o2 = ls[2 * k + 3];
        const float2 q0 = make_float2(0.5f * (e2.x + o2.x), 0.5f * (e2.y + o2.y));
        const float2 q1 = make_float2(0.5f * (e2.x - o2.x), 0.5f * (e2.y - o2.y));
        acc += abs2(make_float2(q0.x - p0.x, q0.y - p0.y)) +
               abs2(make_float2(q1.x - p1.x, q1.y - p1.y));
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < P * n_pil; i += blockDim.x) {
      const int p = i / n_pil, j = i - p * n_pil;
      const float2* src = hp + p * n_pil;
      if (window <= 1) {
        hs[i] = src[j];
        continue;
      }
      float2 s = make_float2(0.f, 0.f);  // replicate-padded window sum
      for (int q = j - pad_l; q <= j + pad_r; ++q)
        s = add(s, src[min(max(q, 0), n_pil - 1)]);
      hs[i] = make_float2(s.x / window, s.y / window);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < P * M; i += blockDim.x) {
      const int p = i / M, m = i - p * M;
      const float2* src = hs + p * n_pil;
      float2 v;
      if (((m - delta) & 1) == 0) {          // on the comb
        v = src[(m - delta) >> 1];
      } else if (delta == 0) {               // odd SC: mean of neighbours, hold at the top
        const int k = m >> 1;
        const float2 a = src[k], c = src[min(k + 1, n_pil - 1)];
        v = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y + c.y));
      } else {                               // even SC: hold at the bottom
        const int k = m >> 1;
        if (k == 0) {
          v = src[0];
        } else {
          const float2 a = src[k - 1], c = src[k];
          v = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y + c.y));
        }
      }
      h[((size_t)(b * R + r) * P + p) * M + m] = v;
    }
    __syncthreads();  // ls / hp / hs are reused by the next antenna
  }

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < blockDim.x / 32 ? red[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) {
      const float scale = P == 1 ? 1.f / (2.f * R * n_dmrs * (n_pil - 1))
                                 : (float)n_dmrs / ((float)R * P * (n_pair - 1));
      nvar[b] = v * scale;
    }
  }
}

// The qm max-log LLRs of one compensated symbol (x, mag); llr.py's order.
__device__ __forceinline__ void llr_bits(float re, float im, float mag, int qm,
                                         float* o) {
  if (qm == 2) {
    const float s = 0.70710678118654752f;
    o[0] = re * s;
    o[1] = im * s;
  } else if (qm == 4) {
    const float t = 2.f * 0.31622776601683794f * mag;
    o[0] = re;
    o[1] = im;
    o[2] = t - fabsf(re);
    o[3] = t - fabsf(im);
  } else if (qm == 6) {
    const float s = 0.15430334996209191f;
    const float t4 = 4.f * s * mag, t2 = 2.f * s * mag;
    o[0] = re;
    o[1] = im;
    o[2] = t4 - fabsf(re);
    o[3] = t4 - fabsf(im);
    o[4] = t2 - fabsf(o[2]);
    o[5] = t2 - fabsf(o[3]);
  } else {  // qm == 8
    const float s = 0.07669649888473704f;
    const float t8 = 8.f * s * mag, t4 = 4.f * s * mag, t2 = 2.f * s * mag;
    o[0] = re;
    o[1] = im;
    o[2] = t8 - fabsf(re);
    o[3] = t8 - fabsf(im);
    o[4] = t4 - fabsf(o[2]);
    o[5] = t4 - fabsf(o[3]);
    o[6] = t2 - fabsf(o[4]);
    o[7] = t2 - fabsf(o[5]);
  }
}

// planes: (B, qm, n_data * M * P); codeword bit (re, l, j) sits at
// planes[b, j, re * P + l] and is scrambled by cbits[(re * P + l) * qm + j].
__global__ void __launch_bounds__(kEqThreads)
equalize_llr_kernel(const float2* __restrict__ y, const float2* __restrict__ h,
                    const float* __restrict__ nvar,
                    const int* __restrict__ data_syms,
                    const uint8_t* __restrict__ cbits, float* __restrict__ planes,
                    int R, int P, int n_sym, int n_sc, int a0, int M, int n_data,
                    int qm) {
  const int b = blockIdx.y;
  const int n_re = n_data * M;
  const int re = blockIdx.x * blockDim.x + threadIdx.x;
  if (re >= n_re) return;
  const int i = re / M, m = re - i * M;
  const int s = data_syms[i];

  float2 x0 = make_float2(0.f, 0.f), x1 = x0, g01 = x0;
  float g00 = 0.f, g11 = 0.f;
  for (int r = 0; r < R; ++r) {
    const float2 yv = y[((size_t)(b * R + r) * n_sym + s) * n_sc + a0 + m];
    const float2 h0 = h[((size_t)(b * R + r) * P) * M + m];
    x0 = add(x0, mul_conj(yv, h0));
    g00 += abs2(h0);
    if (P == 2) {
      const float2 h1 = h[((size_t)(b * R + r) * P + 1) * M + m];
      x1 = add(x1, mul_conj(yv, h1));
      g11 += abs2(h1);
      g01 = add(g01, mul_conj(h1, h0));  // conj(h0) * h1
    }
  }
  float ex[2][2], mag[2];
  if (P == 1) {
    ex[0][0] = x0.x;
    ex[0][1] = x0.y;
    mag[0] = g00;
  } else {  // closed-form 2x2 MMSE, equalization.py::mmse_equalize_2layer
    const float nv = nvar[b];
    const float a00 = g00 + nv, a11 = g11 + nv;
    const float ag2 = abs2(g01);
    const float inv = 1.f / (a00 * a11 - ag2);
    // e0 = (a11 x0 - g01 x1) inv ; e1 = (a00 x1 - conj(g01) x0) inv
    ex[0][0] = (a11 * x0.x - (g01.x * x1.x - g01.y * x1.y)) * inv;
    ex[0][1] = (a11 * x0.y - (g01.x * x1.y + g01.y * x1.x)) * inv;
    ex[1][0] = (a00 * x1.x - (g01.x * x0.x + g01.y * x0.y)) * inv;
    ex[1][1] = (a00 * x1.y - (g01.x * x0.y - g01.y * x0.x)) * inv;
    mag[0] = (a11 * g00 - ag2) * inv;
    mag[1] = (a00 * g11 - ag2) * inv;
  }
  const size_t plane_len = (size_t)n_re * P;
  for (int l = 0; l < P; ++l) {
    float o[8];
    llr_bits(ex[l][0], ex[l][1], mag[l], qm, o);
    const size_t f = (size_t)re * P + l;
    for (int j = 0; j < qm; ++j) {
      const float v = cbits[f * qm + j] ? -o[j] : o[j];
      planes[((size_t)b * qm + j) * plane_len + f] = v;
    }
  }
}

}  // namespace

// y (B, R, n_sym, n_sc) complex64 -> planes (B, qm, n_data*12*n_prb*P) f32.
// pilots (n_dmrs, 6*n_prb) complex64; dmrs_syms (n_dmrs,), data_syms
// (n_data,) int32; cbits (G,) uint8 scrambling sequence; h (B, R, P,
// 12*n_prb) complex64 and nvar (B,) f32 are scratch.  All tensors on CUDA
// device `device`.
extern "C" int pusch_frontend(const void* y, const void* pilots,
                              const void* dmrs_syms, const void* data_syms,
                              const void* cbits, void* h, void* nvar,
                              void* planes, int B, int R, int P, int n_sym,
                              int n_sc, int a0, int n_prb, int delta,
                              int n_dmrs, int n_data, int qm, int window,
                              int device, void* stream) {
  if (B == 0) return 0;
  const oai5g::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pil = 6 * n_prb;
  const int M = 12 * n_prb;
  const int smem = (1 + 2 * P) * n_pil * (int)sizeof(float2);
  static oai5g::SmemLimit limit;
  cudaError_t err = limit.reserve(reinterpret_cast<const void*>(estimate_kernel), device, smem);
  if (err != cudaSuccess) return (int)err;
  estimate_kernel<<<B, kEstThreads, smem, s>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(pilots),
      static_cast<const int*>(dmrs_syms), static_cast<float2*>(h),
      static_cast<float*>(nvar), R, P, n_sym, n_sc, a0, n_pil, delta, n_dmrs,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_data * M + kEqThreads - 1) / kEqThreads, B);
  equalize_llr_kernel<<<grid, kEqThreads, 0, s>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(h),
      static_cast<const float*>(nvar), static_cast<const int*>(data_syms),
      static_cast<const uint8_t*>(cbits), static_cast<float*>(planes), R, P,
      n_sym, n_sc, a0, M, n_data, qm);
  return (int)cudaGetLastError();
}
