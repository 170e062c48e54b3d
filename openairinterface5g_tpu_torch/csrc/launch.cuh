// The C side of the port's launch route, shared by every entry point in
// csrc/*.cu.
//
// An entry point takes its tensors' device index and PyTorch's current
// stream on that device as a raw cudaStream_t, launches on that stream and
// returns cudaGetLastError().  Two things that once ran on every launch now
// cost next to nothing when nothing changes:
//   * DeviceGuard makes the tensors' device current only where it is not
//     already (a launch into another device's stream fails), so the usual
//     launch costs one cudaGetDevice and no Python context manager;
//   * SmemLimit raises a kernel's dynamic shared-memory limit only when a
//     launch needs more than every earlier launch on that device, so the
//     main path calls cudaFuncSetAttribute once per kernel, not per launch.
//   * ClusterLimit allows a kernel clusters above the portable 8 blocks
//     (the H100 runs 16), once per kernel and device.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace oai5g {

// Makes `device` the current device for the guard's lifetime and restores
// the previous one after; does nothing when `device` already is current.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

constexpr int kMaxDevices = 64;

// The dynamic shared-memory limit of one kernel on each device: raised to
// what a launch needs only when that is more than the limit set so far.
// Declare one as a function-local static per kernel instantiation and call
// reserve() with the current device set (inside a DeviceGuard).
class SmemLimit {
 public:
  cudaError_t reserve(const void* kernel, int device, int bytes) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (bytes <= limit_[device].load(std::memory_order_acquire)) return cudaSuccess;
    std::lock_guard<std::mutex> lock(mu_);
    if (bytes <= limit_[device].load(std::memory_order_relaxed)) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) limit_[device].store(bytes, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<int> limit_[kMaxDevices] = {};
  std::mutex mu_;
};

// Allows one kernel thread-block clusters of up to 16 blocks on each
// device, setting the attribute once per device.  Declare one as a
// function-local static per kernel and call allow() with the current device
// set, before a cluster launch or an occupancy query above 8 blocks.
class ClusterLimit {
 public:
  cudaError_t allow(const void* kernel, int device) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (set_[device].load(std::memory_order_acquire)) return cudaSuccess;
    std::lock_guard<std::mutex> lock(mu_);
    if (set_[device].load(std::memory_order_relaxed)) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) set_[device].store(true, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<bool> set_[kMaxDevices] = {};
  std::mutex mu_;
};

}  // namespace oai5g
