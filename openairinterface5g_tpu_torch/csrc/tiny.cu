// T1 and T2: launch-cost probes, out = x * 2 in f32.
//
// Replace the Pallas kernels of tools/bench_overhead.py: T1 `tiny` (one
// block over (8, 128)) and T2 `tiny_grid` (a grid of 8 blocks over
// (8, 8, 128), one (1, 8, 128) slab each).  Their work is nothing: 4 KiB or
// 32 KiB read and written, so what they measure is the fixed cost of one
// kernel launch on the card.  Each block here is 1024 threads, one element
// per thread; T1 launches one block, T2 eight.  Their time by CUDA events
// over back-to-back calls is the host cost of the launch route
// (launch.cuh, ops/_cuda.py), which every kernel of the port shares; the
// data-sheet bound of their bytes (a few ns) is out of reach of any launch.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kBlock = 8 * 128;    // one (8, 128) tile per block

__global__ void __launch_bounds__(kBlock) times_two_kernel(const float* __restrict__ x,
                                                           float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  out[i] = x[i] * 2.f;
}

}  // namespace

// x, out: (n_blocks * 8 * 128,) f32 on CUDA device `device`; n_blocks = 1
// for T1, 8 for T2.
extern "C" int tiny_times_two(const void* x, void* out, int n_blocks, int device,
                              void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const oai5g::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  times_two_kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
