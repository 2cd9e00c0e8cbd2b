// Three nearest known points of every unknown point, one warp per unknown.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
// (three_nn_pallas, the query-major kernel that the JAX package takes where
// the known-major three_nn_pallas_t is refused: a query count that its
// tiles do not divide, or m > 4096). Contract, as three_nn.cu: the three
// smallest d^2 in ascending order with their int32 indices, the lowest
// index winning a tie, d^2 from sqdist.cuh, bit for bit.
//
// Bound on the card: operations, n x m distance evaluations. The TPU kernel
// built a (TM, m) distance tile per query tile and ran three min / argmin /
// knock-out passes over it. Here a query's scan is spread over the 32 lanes
// of its warp (three_nn.cu gives it one thread): lane l takes known points
// l, l + 32, ... in ascending order with a strict-< running top-3, so each
// lane holds its own three smallest (d^2, index) pairs in lexicographic
// order; three rounds of a warp-wide lexicographic minimum then pop the
// overall three, which is what the knock-out passes select, ties included.
// The block's warps share the known points through shared memory, kTile at
// a time; consecutive lanes read consecutive words (no bank conflicts).
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;  // known points a block stages at once (24 KiB)

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
    three_nn_q_kernel(const float* __restrict__ unknown,
                      const float* __restrict__ known, int n, int m,
                      float* __restrict__ dist2, int* __restrict__ idx) {
  __shared__ float kx[kTile];
  __shared__ float ky[kTile];
  __shared__ float kz[kTile];
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = q < n;  // warp-uniform
  const long long row = b * n + q;

  float ux = 0.f, uy = 0.f, uz = 0.f;
  if (active) {
    ux = unknown[3 * row];
    uy = unknown[3 * row + 1];
    uz = unknown[3 * row + 2];
  }
  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = INT_MAX, i1 = INT_MAX, i2 = INT_MAX;
  const float* kb = known + b * m * 3;

  for (int base = 0; base < m; base += kTile) {
    const int cnt = (m - base) < kTile ? (m - base) : kTile;
    __syncthreads();  // the previous tile has been read by every warp
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      kx[t] = kb[3 * (base + t)];
      ky[t] = kb[3 * (base + t) + 1];
      kz[t] = kb[3 * (base + t) + 2];
    }
    __syncthreads();
    if (active) {
      for (int t = lane; t < cnt; t += 32) {
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
  if (!active) return;

  // three rounds: the warp's lexicographic minimum of the lanes' heads, then
  // the lane that held it (indices are distinct across lanes) pops its head
  float out_d[3];
  int out_i[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float bd = d0;
    int bi = i0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    out_d[s] = bd;
    out_i[s] = bi;
    if (i0 == bi) {
      d0 = d1; i0 = i1;
      d1 = d2; i1 = i2;
      d2 = CUDART_INF_F; i2 = INT_MAX;
    }
  }
  if (lane == 0) {
    for (int s = 0; s < 3; ++s) {
      dist2[3 * row + s] = out_d[s];
      idx[3 * row + s] = out_i[s];
    }
  }
}

}  // namespace

extern "C" int p2_three_nn_q(const float* unknown, const float* known, int B,
                             int n, int m, float* dist2, int* idx,
                             void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (m < 3 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kWarps - 1) / kWarps, B);
  three_nn_q_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      unknown, known, n, m, dist2, idx);
  return static_cast<int>(cudaGetLastError());
}
