// Raises a kernel's dynamic shared-memory limit once per device and size:
// cudaFuncSetAttribute costs the host more time than launching a small
// kernel, so each launch site keeps what it has already set in a static
// array of its own (one entry per device) and calls it only to go higher.
// Under CUDA graph capture (the fused train steps) no call is made: their
// warm-up runs every launch at the captured shapes before the capture, so
// the capture finds each limit raised already.
#pragma once

#include <cuda_runtime.h>

constexpr int kP2MaxDevices = 64;

template <typename Kernel>
inline cudaError_t p2_allow_smem(Kernel kernel, size_t bytes, int (&allowed)[kP2MaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int want = static_cast<int>(bytes);
  if (dev < kP2MaxDevices && want <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  if (err == cudaSuccess && dev < kP2MaxDevices) allowed[dev] = want;
  return err;
}
