// Row gather fused with the layer-0 matrix product:
// out[b, j, f] = sum over c of w[c, f] * src[b, idx[b, j], c].
//
// Replaces scripts/bench_fused_sa.py:69 (fused_gather_mm), the experiment
// that fuses SA1's layer-0 matmul into the chunk-select VMEM gather. The TPU
// kernel rebuilds each gathered (C, S, 128) tile out of 128-lane selects over
// all N / 128 source chunks, because the TPU has no general gather, then
// runs the C x F multiply-adds on the VPU. This kernel computes the
// function, not that method: the card loads any address.
//
// Bound on the card: bytes. At the script's shape (B 32, N 8192, J 32768,
// C 9, F 32) the output alone is 134 MB, the distinct source rows 9.3 MB and
// the indices 4.2 MB; the 6e8 operations take a fifth of the bytes' time.
// So the design keeps w (C x F words) in shared memory, reads each index
// and each source word from device memory once (the threads of one output
// row read the same words: L1 broadcasts), and writes each output word
// once, four consecutive words a thread in one 16-byte store where F % 4 ==
// 0.
//
// Rounding: each output starts at 0 and adds w[c, f] * g[c] for c
// ascending, every multiply and add rounded on its own (__fmul_rn,
// __fadd_rn; the library also builds with -fmad=false). The plain PyTorch
// version adds in the same order, so the two are equal bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // consecutive output words a thread
constexpr int kMaxSmemBytes = 200 * 1024;

__global__ void __launch_bounds__(kThreads)
    fused_gather_mm_kernel(const float* __restrict__ src,
                           const int* __restrict__ idx,
                           const float* __restrict__ w, int N, int J, int C,
                           int F, long long items, bool vec,
                           float* __restrict__ out) {
  extern __shared__ float ws[];  // (C, F)
  for (int t = threadIdx.x; t < C * F; t += kThreads) ws[t] = w[t];
  __syncthreads();

  const int slices = (F + kVec - 1) / kVec;  // items of an output row
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       t < items; t += stride) {
    const long long row = t / slices;  // b * J + j
    const int f0 = static_cast<int>(t - row * slices) * kVec;
    const long long b = row / J;
    const float* g = src + (b * N + idx[row]) * C;
    float o[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < C; ++c) {
      const float gc = g[c];
      const float* wc = ws + c * F + f0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (f0 + k < F) o[k] = __fadd_rn(o[k], __fmul_rn(wc[k], gc));
      }
    }
    float* dst = out + row * F + f0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      for (int k = 0; k < kVec && f0 + k < F; ++k) dst[k] = o[k];
    }
  }
}

}  // namespace

// src (B, N, C), w (C, F) and out (B, J, F) float32; idx (B, J) int32
// indices that the caller guarantees lie in [0, N). C * F * 4 <= 200 KiB.
extern "C" int p2_fused_gather_mm(const float* src, const int* idx,
                                  const float* w, int B, int N, int J, int C,
                                  int F, float* out, void* stream) {
  if (B <= 0 || J <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || C <= 0 ||
      static_cast<long long>(C) * F * sizeof(float) > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(C) * F * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gather_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>(B) * J * ((F + kVec - 1) / kVec);
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  const bool vec =
      F % kVec == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  fused_gather_mm_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      src, idx, w, N, J, C, F, items, vec, out);
  return static_cast<int>(cudaGetLastError());
}
