// Three nearest known points of every unknown point, one thread per unknown.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
// (three_nn_pallas_t). Contract: the three smallest d^2 in ascending order
// with their int32 indices, the lowest index winning a tie.
//
// Bound on the card: FLOPs and shared-memory reads, n x m distance
// evaluations (268 M at FP0 with B = 32). The TPU kernel built an (m, TN)
// distance tile and ran three min / argmin / knock-out passes over it. Here
// each thread keeps a running top-3 in registers and scans the known points in
// ascending index order with strict-< insertion, which gives the same answer
// as the knock-out passes, ties included, with one pass and no tile. The
// block stages the known points of its batch row through shared memory, 1024
// at a time (12 KiB), and every thread reads the same word at once (a
// broadcast, no bank conflicts).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void three_nn_kernel(const float* __restrict__ unknown,
                                const float* __restrict__ known, int n, int m,
                                float* __restrict__ dist2,
                                int* __restrict__ idx) {
  __shared__ float kx[kTile];
  __shared__ float ky[kTile];
  __shared__ float kz[kTile];
  const long long b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool active = j < n;
  const long long row = b * n + j;

  float ux = 0.f, uy = 0.f, uz = 0.f;
  if (active) {
    ux = unknown[3 * row];
    uy = unknown[3 * row + 1];
    uz = unknown[3 * row + 2];
  }
  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = 0, i1 = 0, i2 = 0;
  const float* kb = known + b * m * 3;

  for (int base = 0; base < m; base += kTile) {
    const int cnt = (m - base) < kTile ? (m - base) : kTile;
    __syncthreads();  // the previous tile has been read by every thread
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      kx[t] = kb[3 * (base + t)];
      ky[t] = kb[3 * (base + t) + 1];
      kz[t] = kb[3 * (base + t) + 2];
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < cnt; ++t) {
        const float d = p2_sqdist(ux, uy, uz, kx[t], ky[t], kz[t]);
        const int k = base + t;
        if (d < d0) {
          d2 = d1; i2 = i1;
          d1 = d0; i1 = i0;
          d0 = d; i0 = k;
        } else if (d < d1) {
          d2 = d1; i2 = i1;
          d1 = d; i1 = k;
        } else if (d < d2) {
          d2 = d; i2 = k;
        }
      }
    }
  }
  if (active) {
    dist2[3 * row] = d0;
    dist2[3 * row + 1] = d1;
    dist2[3 * row + 2] = d2;
    idx[3 * row] = i0;
    idx[3 * row + 1] = i1;
    idx[3 * row + 2] = i2;
  }
}

}  // namespace

extern "C" int p2_three_nn(const float* unknown, const float* known, int B,
                           int n, int m, float* dist2, int* idx, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (m < 3 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, B);
  three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      unknown, known, n, m, dist2, idx);
  return static_cast<int>(cudaGetLastError());
}
