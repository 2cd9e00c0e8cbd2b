// Single-radius ball query: one warp per query at a time, the batch row's
// points staged in shared memory.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
// (ball_query_pallas). Contract: the first nsample indices with
// d^2 < r^2 in ascending index order, r^2 = f32(r) * f32(r); a short row is
// padded with its first hit and an empty ball gives an all-zero row.
//
// Bound on the card: instruction issue, about 10 issue slots per point a
// query's scan reads (d^2's 8 unfused operations, a compare, shares of the
// ballots, loads and loop), more in steps with hits; at SSG's SA1 a query
// reads about 61% of its 8192 points before its 32nd hit, so early exit
// saves little. The TPU kernel materialised a (TM, N) distance tile and ran
// nsample masked-min passes over it; here a warp tests 128 points a step,
// four a lane, and a ballot per 32 consecutive points with a popcount of
// the lanes below gives each hit its slot, so hits are appended in index
// order with no sort and the scan stops once the row is full. Every query
// of a block scans its batch row from shared memory (from global memory,
// three stride-3 floats a point would cost about nine L1 wavefronts per 32
// points), stored as x, y and z arrays permuted so that one 16-byte load
// gives a lane the points l, l + 32, l + 64 and l + 96 of a step: three
// conflict-free loads serve 128 points, and the ballots still cover 32
// consecutive indices each. The row is padded to a whole step with +inf,
// which never hits. ball_query_kernel.plan() picks the route:
// - resident: a row of up to RESIDENT_POINTS points stays whole in shared
//   memory; a finished warp takes its block's next query from a shared
//   counter, so every query stops at its own nsample-th hit;
// - tiled: a longer row streams through two buffers of `tile` points filled
//   by cp.async; each warp scans the tile for each of its unfinished
//   queries (their counts kept in shared memory), and the block stops
//   loading tiles once all its queries are full.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "on_device.cuh"
#include "smem_limit.cuh"
#include "sqdist.cuh"

namespace {

constexpr int kStep = 128;  // points a warp tests a step: 4 a lane
constexpr int kMaxWarps = 32;
constexpr int kMaxTiledQueries = 256;  // queries a block of the tiled route holds counts for

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Slot of point p (of a tile) in its coordinate array: step s = p / 128
// keeps, in float4 s * 32 + l, the points s * 128 + l + 32 * j, j = 0..3.
__device__ __forceinline__ int slot_of(int p) {
  const int r = p & (kStep - 1);
  return (p - r) + 4 * (r & 31) + (r >> 5);
}

// Stage points [base, base + cnt) of a row into x, y and z arrays of pad
// floats each (cnt <= pad, pad a multiple of kStep), the tail +inf: one
// cp.async group, coalesced reads of the row's words.
__device__ __forceinline__ void stage(float* dst, int pad, const float* row, int base, int cnt) {
  const float* src = row + 3LL * base;
  for (int w = threadIdx.x; w < 3 * cnt; w += blockDim.x) {
    const int p = w / 3;
    cp_async4(dst + (w - 3 * p) * pad + slot_of(p), src + w);
  }
  for (int p = cnt + threadIdx.x; p < pad; p += blockDim.x) {
    const int s = slot_of(p);
    dst[s] = dst[pad + s] = dst[2 * pad + s] = CUDART_INF_F;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One ballot's 32 consecutive points (indices i - lane .. i - lane + 31):
// append the hits in index order, slots past nsample dropped.
__device__ __forceinline__ void append(unsigned mask, bool hit, int i, int lane, int nsample,
                                       int& cnt, int& first, int* row) {
  if (mask != 0u) {  // warp-uniform
    if (cnt == 0) first = i - lane + __ffs(mask) - 1;
    const int slot = cnt + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < nsample) row[slot] = i;
    cnt += __popc(mask);
  }
}

// The calling warp scans `steps` steps of a staged tile (pad floats a
// coordinate) for one query; base is the row index of the tile's first
// point. Stops once cnt reaches nsample.
__device__ __forceinline__ void scan(const float* tile, int pad, int steps, int base, float qx,
                                     float qy, float qz, float r2, int nsample, int lane, int& cnt,
                                     int& first, int* row) {
  const float4* X = reinterpret_cast<const float4*>(tile);
  const float4* Y = reinterpret_cast<const float4*>(tile + pad);
  const float4* Z = reinterpret_cast<const float4*>(tile + 2 * pad);
  for (int s = 0; s < steps && cnt < nsample; ++s) {
    const float4 x = X[s * 32 + lane];
    const float4 y = Y[s * 32 + lane];
    const float4 z = Z[s * 32 + lane];
    const bool h0 = p2_sqdist(qx, qy, qz, x.x, y.x, z.x) < r2;
    const bool h1 = p2_sqdist(qx, qy, qz, x.y, y.y, z.y) < r2;
    const bool h2 = p2_sqdist(qx, qy, qz, x.z, y.z, z.z) < r2;
    const bool h3 = p2_sqdist(qx, qy, qz, x.w, y.w, z.w) < r2;
    const unsigned m0 = __ballot_sync(0xffffffffu, h0);
    const unsigned m1 = __ballot_sync(0xffffffffu, h1);
    const unsigned m2 = __ballot_sync(0xffffffffu, h2);
    const unsigned m3 = __ballot_sync(0xffffffffu, h3);
    if ((m0 | m1 | m2 | m3) == 0u) continue;
    const int i = base + s * kStep + lane;
    append(m0, h0, i, lane, nsample, cnt, first, row);
    append(m1, h1, i + 32, lane, nsample, cnt, first, row);
    append(m2, h2, i + 64, lane, nsample, cnt, first, row);
    append(m3, h3, i + 96, lane, nsample, cnt, first, row);
  }
}

// Fill a query's row past its hits with its first hit (0 for an empty ball).
__device__ __forceinline__ void pad_row(int cnt, int first, int nsample, int lane, int* row) {
  for (int s = (cnt < nsample ? cnt : nsample) + lane; s < nsample; s += 32) row[s] = first;
}

// grid (blocks a row, B): block x of row b takes queries
// [x * per_block, min((x + 1) * per_block, M)); the row (pad floats a
// coordinate) in dynamic shared memory.
__global__ void __launch_bounds__(kMaxWarps * 32)
    ball_query_resident_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                               int N, int M, int pad, int per_block, float radius, int nsample,
                               int* __restrict__ out) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  float* pts = reinterpret_cast<float*>(smem4);
  __shared__ int next;
  const long long b = blockIdx.y;
  const int q0 = blockIdx.x * per_block;
  const int q1 = (q0 + per_block) < M ? (q0 + per_block) : M;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) next = q0;
  stage(pts, pad, xyz + b * N * 3, 0, N);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const float r2 = __fmul_rn(radius, radius);
  for (;;) {
    int q = 0;
    if (lane == 0) q = atomicAdd(&next, 1);
    q = __shfl_sync(0xffffffffu, q, 0);
    if (q >= q1) break;
    const long long g = b * M + q;
    int* row = out + g * nsample;
    int cnt = 0, first = 0;
    scan(pts, pad, pad / kStep, 0, new_xyz[3 * g], new_xyz[3 * g + 1], new_xyz[3 * g + 2], r2,
         nsample, lane, cnt, first, row);
    pad_row(cnt, first, nsample, lane, row);
  }
}

// grid (blocks a row, B) as above, per_block <= kMaxTiledQueries; two
// buffers of tile points (3 * tile floats each) in dynamic shared memory.
__global__ void __launch_bounds__(kMaxWarps * 32)
    ball_query_tiled_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                            int N, int M, int tile, int per_block, float radius, int nsample,
                            int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);
  __shared__ int cnts[kMaxTiledQueries];
  __shared__ int firsts[kMaxTiledQueries];
  const long long b = blockIdx.y;
  const int q0 = blockIdx.x * per_block;
  const int nq = ((q0 + per_block) < M ? (q0 + per_block) : M) - q0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < nq; k += blockDim.x) cnts[k] = firsts[k] = 0;
  const float* row_pts = xyz + b * N * 3;
  const float r2 = __fmul_rn(radius, radius);
  const int ntiles = (N + tile - 1) / tile;
  stage(bufs, tile, row_pts, 0, N < tile ? N : tile);
  for (int t = 0; t < ntiles; ++t) {
    const int base = t * tile;
    const int cnt_t = (N - base) < tile ? (N - base) : tile;
    if (t + 1 < ntiles) {
      const int next = N - base - tile;
      stage(bufs + ((t + 1) & 1) * 3 * tile, tile, row_pts, base + tile, next < tile ? next : tile);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t (and, at t = 0, the cleared counts) seen by every warp
    const float* buf = bufs + (t & 1) * 3 * tile;
    bool alive = false;
    for (int k = warp; k < nq; k += warps) {
      int cnt = cnts[k];
      if (cnt >= nsample) continue;
      int first = firsts[k];
      const long long g = b * M + q0 + k;
      scan(buf, tile, (cnt_t + kStep - 1) / kStep, base, new_xyz[3 * g], new_xyz[3 * g + 1],
           new_xyz[3 * g + 2], r2, nsample, lane, cnt, first, out + g * nsample);
      __syncwarp();
      if (lane == 0) {
        cnts[k] = cnt;
        firsts[k] = first;
      }
      alive |= cnt < nsample;
    }
    // every warp is done with tile t before t + 2 refills its buffer; stop
    // once no query of the block wants more points
    if (!__syncthreads_or(alive)) break;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // a tile still in flight after an early stop
  for (int k = warp; k < nq; k += warps) {
    const long long g = b * M + q0 + k;
    pad_row(cnts[k], firsts[k], nsample, lane, out + g * nsample);
  }
}

int g_resident_smem[kP2MaxDevices];
int g_tiled_smem[kP2MaxDevices];

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) float32 -> out (B, M, nsample) int32.
// tiled 0: the resident route, tile = N rounded up to a multiple of 128;
// tiled 1: two buffers of tile points (a multiple of 128). warps a block,
// per_block queries a block: ball_query_kernel.plan(). device: the card
// that holds the tensors.
extern "C" int p2_ball_query(const float* xyz, const float* new_xyz, int B, int N, int M,
                             float radius, int nsample, int tiled, int tile, int warps,
                             int per_block, int* out, int device, void* stream) {
  if (static_cast<long long>(B) * M <= 0 || nsample <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || B > 65535 || warps <= 0 || warps > kMaxWarps || per_block <= 0 || tile <= 0 ||
      tile % kStep != 0 || (tiled ? per_block > kMaxTiledQueries : tile < N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (tiled ? 2 : 1) * 3 * sizeof(float) * static_cast<size_t>(tile);
  const dim3 grid((M + per_block - 1) / per_block, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p2_on_device(device, [&] {
    cudaError_t err;
    if (tiled) {
      err = p2_allow_smem(ball_query_tiled_kernel, smem, g_tiled_smem);
      if (err != cudaSuccess) return err;
      ball_query_tiled_kernel<<<grid, warps * 32, smem, s>>>(xyz, new_xyz, N, M, tile, per_block,
                                                             radius, nsample, out);
    } else {
      err = p2_allow_smem(ball_query_resident_kernel, smem, g_resident_smem);
      if (err != cudaSuccess) return err;
      ball_query_resident_kernel<<<grid, warps * 32, smem, s>>>(xyz, new_xyz, N, M, tile,
                                                                per_block, radius, nsample, out);
    }
    return cudaGetLastError();
  }));
}
