// Runs a C entry point's launches with the card that holds its tensors
// current, and makes the caller's card current again after, as
// torch.cuda.device(...) does around a call, in far less host time: for
// the small kernels of the deep levels the wrapper's host time is the
// kernel's time. cudaGetDevice and, where the cards differ, cudaSetDevice
// are the only calls added.
#pragma once

#include <cuda_runtime.h>

template <typename Launch>
inline cudaError_t p2_on_device(int device, Launch&& launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
}
