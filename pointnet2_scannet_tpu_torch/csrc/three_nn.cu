// Three nearest known points of every unknown point: each thread holds Q
// unknown points (1, 2 or 4) in registers and scans the known points of its
// batch row from shared memory.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
// (three_nn_pallas_t). Contract: the three smallest d^2 in ascending order
// with their int32 indices, the lowest index winning a tie.
//
// Bound on the card: instruction issue, n x m distance evaluations (268 M
// at FP0 with B = 32). A pair costs 8 floating-point instructions (d^2
// stays unfused, as the plain version rounds it), a compare, a vote and a
// branch; an FMA-free f32 pipe issues one of them a clock, so about twice
// the table's operations bound (which counts an FMA as two) is the floor.
// The TPU kernel built an (m, TN) distance tile and ran three min / argmin
// / knock-out passes over it. Here each query keeps a running top-3 in
// registers and scans the known points in ascending index order with
// strict-< insertion, which gives the knock-out passes' answer, ties
// included, with one pass and no tile. What the design does about the
// bound: the known points sit in shared memory as float4 (x, y, z, pad), so
// one 16-byte broadcast load feeds Q distance evaluations; the insertion
// sits behind a warp vote (a lane inserts at ~21 of FP0's 1024 points, but
// some lane of a warp at a quarter of them), so the common pair costs the
// distance, a compare, the vote and a uniform branch, with no convergence
// barrier, and an insertion is straight-line selects; the tiles of kTile
// points are filled by cp.async, double-buffered where m exceeds one tile.
// The launch shape comes from three_nn_kernel.plan(): Q and the block size
// shrink at the deep levels so that their few queries still spread over
// the card.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "on_device.cuh"
#include "sqdist.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 1024;  // known points a buffer holds (16 KiB as float4)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Stage known points [base, base + cnt) of a row as (x, y, z, pad): the
// block's threads copy consecutive words (coalesced reads), each into its
// point's slot; one cp.async group.
__device__ __forceinline__ void stage(float4* tile, const float* kb, int base, int cnt) {
  const float* src = kb + 3LL * base;
  float* dst = reinterpret_cast<float*>(tile);
  for (int w = threadIdx.x; w < 3 * cnt; w += blockDim.x) {
    const int p = w / 3;
    cp_async4(dst + 4 * p + (w - 3 * p), src + w);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
    three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int n,
                    int m, float* __restrict__ dist2, int* __restrict__ idx) {
  __shared__ float4 tiles[2][kTile];
  const long long b = blockIdx.y;
  // this thread's queries: j0 + q * blockDim.x (coalesced loads and stores)
  const int j0 = blockIdx.x * (Q * blockDim.x) + threadIdx.x;
  float ux[Q], uy[Q], uz[Q], d0[Q], d1[Q], d2[Q];
  int i0[Q], i1[Q], i2[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = j0 + q * blockDim.x;
    const float* u = unknown + 3 * (b * n + (j < n ? j : 0));  // an idle slot scans row 0's point
    ux[q] = u[0];
    uy[q] = u[1];
    uz[q] = u[2];
    d0[q] = d1[q] = d2[q] = CUDART_INF_F;
    i0[q] = i1[q] = i2[q] = 0;
  }
  const float* kb = known + b * m * 3;
  const int ntiles = (m + kTile - 1) / kTile;
  stage(tiles[0], kb, 0, m < kTile ? m : kTile);
  for (int t = 0; t < ntiles; ++t) {
    const int base = t * kTile;
    const int cnt = (m - base) < kTile ? (m - base) : kTile;
    if (t + 1 < ntiles) {
      const int next = m - base - kTile;
      stage(tiles[(t + 1) & 1], kb, base + kTile, next < kTile ? next : kTile);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t is in shared memory for every thread
    const float4* tile = tiles[t & 1];
#pragma unroll 2
    for (int s = 0; s < cnt; ++s) {
      const float4 p = tile[s];
      const int k = base + s;
      float d[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) d[q] = p2_sqdist(ux[q], uy[q], uz[q], p.x, p.y, p.z);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        // warp-uniform, so no convergence barrier: the warp enters when any
        // lane's query takes the point, and each lane inserts by selects
        if (__any_sync(0xffffffffu, d[q] < d2[q])) {
          const bool c2 = d[q] < d2[q], c1 = d[q] < d1[q], c0 = d[q] < d0[q];
          d2[q] = c1 ? d1[q] : (c2 ? d[q] : d2[q]);
          i2[q] = c1 ? i1[q] : (c2 ? k : i2[q]);
          d1[q] = c0 ? d0[q] : (c1 ? d[q] : d1[q]);
          i1[q] = c0 ? i0[q] : (c1 ? k : i1[q]);
          d0[q] = c0 ? d[q] : d0[q];
          i0[q] = c0 ? k : i0[q];
        }
      }
    }
    __syncthreads();  // every thread is done with tile t before t + 2 refills its buffer
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = j0 + q * blockDim.x;
    if (j < n) {
      const long long row = 3 * (b * n + j);
      dist2[row] = d0[q];
      dist2[row + 1] = d1[q];
      dist2[row + 2] = d2[q];
      idx[row] = i0[q];
      idx[row + 1] = i1[q];
      idx[row + 2] = i2[q];
    }
  }
}

template <int Q>
cudaError_t launch(const float* unknown, const float* known, int B, int n, int m, int threads,
                   float* dist2, int* idx, cudaStream_t stream) {
  const dim3 grid((n + Q * threads - 1) / (Q * threads), B);
  three_nn_kernel<Q><<<grid, threads, 0, stream>>>(unknown, known, n, m, dist2, idx);
  return cudaGetLastError();
}

}  // namespace

// unknown (B, n, 3), known (B, m, 3) float32 -> dist2 (B, n, 3) float32 and
// idx (B, n, 3) int32. per_thread (1, 2 or 4) unknown points a thread and
// threads (a multiple of 32, at most 256) a block: three_nn_kernel.plan().
// device: the card that holds the tensors.
extern "C" int p2_three_nn(const float* unknown, const float* known, int B, int n, int m,
                           int per_thread, int threads, float* dist2, int* idx, int device,
                           void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (m < 3 || B > 65535 || threads <= 0 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p2_on_device(device, [&] {
    switch (per_thread) {
      case 1: return launch<1>(unknown, known, B, n, m, threads, dist2, idx, s);
      case 2: return launch<2>(unknown, known, B, n, m, threads, dist2, idx, s);
      case 4: return launch<4>(unknown, known, B, n, m, threads, dist2, idx, s);
      default: return cudaErrorInvalidValue;
    }
  }));
}
