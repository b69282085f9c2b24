// Launch-time CUDA calls made once per device, so that a launch recorded
// into a CUDA graph (cadm_tpu_torch/train/step_graph.py) makes none.
//
// cudaDeviceGetAttribute and cudaFuncSetAttribute are not stream work, and a
// stream capture in PyTorch's default ("global") mode may refuse them. So a
// kernel's first launch on a device, which is eager (a graph's warm-up runs
// the step before its capture), reads the device's attributes and raises the
// kernel's dynamic shared-memory limit to all the device lets a block opt in
// to; every later launch reads the cache and calls neither.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace cadm {

constexpr int kMaxDevices = 64;

struct DeviceAttrs {
  int sms;         // cudaDevAttrMultiProcessorCount
  int smem_sm;     // cudaDevAttrMaxSharedMemoryPerMultiprocessor
  int smem_block;  // cudaDevAttrMaxSharedMemoryPerBlockOptin
};

inline std::mutex& launch_mutex() {
  static std::mutex mu;
  return mu;
}

inline cudaError_t current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    e = cudaErrorInvalidDevice;
  return e;
}

// The current device's attributes, read at the first call on it.
inline cudaError_t device_attrs(DeviceAttrs* out) {
  static DeviceAttrs cache[kMaxDevices];
  static bool known[kMaxDevices];
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(launch_mutex());
  if (!known[dev]) {
    DeviceAttrs a{};
    e = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &a.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &a.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cache[dev] = a;
    known[dev] = true;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// Let `kernel` take up to the device's opt-in maximum of dynamic shared
// memory (less its static shared memory), once per device; `done` is the
// kernel's own flags (a static of its launcher).
inline cudaError_t opt_in_smem(const void* kernel, bool (&done)[kMaxDevices]) {
  DeviceAttrs a{};
  cudaError_t e = device_attrs(&a);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = current_device(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(launch_mutex());
  if (done[dev]) return cudaSuccess;
  cudaFuncAttributes fa{};
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             a.smem_block - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

}  // namespace cadm
