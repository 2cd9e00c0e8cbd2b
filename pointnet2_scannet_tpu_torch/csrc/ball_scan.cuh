// The first-k-hits scan shared by the single-radius ball query (R = 1,
// ball_query.cu) and the two-radius one (R = 2, ball_query_multi.cu).
//
// Contract of each of the R rows: the first nsample indices with
// d^2 < r^2 in ascending index order, r^2 = f32(r) * f32(r); a short row is
// padded with its first hit and an empty ball gives an all-zero row.
//
// A warp scans one query at a time, 128 points a step, four a lane: every
// query of a block scans its batch row from shared memory, stored as x, y
// and z arrays permuted so that one 16-byte load gives a lane the points l,
// l + 32, l + 64 and l + 96 of a step (three conflict-free loads serve 128
// points) while each ballot still covers 32 consecutive indices. A ballot
// per 32 points and a popcount of the lanes below give each hit its slot,
// so hits are appended in index order with no sort. The row is padded to a
// whole step with +inf, which never hits. Two routes, picked by the
// wrappers' plan():
// - resident: a row of up to RESIDENT_POINTS points stays whole in shared
//   memory; a finished warp takes its block's next query from a shared
//   counter, so every query stops at its own last hit;
// - tiled: a longer row streams through two buffers of `tile` points filled
//   by cp.async; each warp scans the tile for each of its unfinished
//   queries (their counts kept in shared memory), and the block stops
//   loading tiles once all its queries are full.
// With two radii, row 0 is the wider one (the entry point orders them): d^2
// is taken once per point and compared with both r^2, the step is skipped
// when row 0's four ballots are empty (the narrow row's hits are a subset),
// and once one row is full the warp goes on with the one-radius scan for
// the other, so a query scans as far as the row that fills last needs.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "smem_limit.cuh"
#include "sqdist.cuh"

namespace {

constexpr int kStep = 128;  // points a warp tests a step: 4 a lane
constexpr int kMaxWarps = 32;
constexpr int kMaxTiledQueries = 256;  // queries a block of the tiled route holds counts for

// The R rows a launch fills: radius, nsample and output (B, M, nsample) of
// each; row 0 has the widest radius.
template <int R>
struct BallRows {
  float radius[R];
  int nsample[R];
  int* out[R];
};

// One query's row while it is scanned.
struct Row {
  float r2;
  int nsample;
  int cnt;    // hits so far (may pass nsample within the step that fills it)
  int first;  // the first hit's index
  int* out;   // the query's nsample slots
};

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
__device__ __forceinline__ void append(unsigned mask, bool hit, int i, int lane, Row& row) {
  if (mask != 0u) {  // warp-uniform
    if (row.cnt == 0) row.first = i - lane + __ffs(mask) - 1;
    const int slot = row.cnt + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < row.nsample) row.out[slot] = i;
    row.cnt += __popc(mask);
  }
}

template <int R>
__device__ __forceinline__ bool all_open(const Row* rows) {
  bool open = rows[0].cnt < rows[0].nsample;
  if constexpr (R == 2) open = open && rows[1].cnt < rows[1].nsample;
  return open;
}

// The calling warp scans steps [s, steps) of a staged tile (pad floats a
// coordinate) for one query against R rows; base is the row index of the
// tile's first point. Stops after the step in which a row is full; returns
// the next step.
template <int R>
__device__ __forceinline__ int scan_steps(const float* tile, int pad, int s, int steps, int base,
                                          float qx, float qy, float qz, int lane, Row* rows) {
  const float4* X = reinterpret_cast<const float4*>(tile);
  const float4* Y = reinterpret_cast<const float4*>(tile + pad);
  const float4* Z = reinterpret_cast<const float4*>(tile + 2 * pad);
  for (; s < steps && all_open<R>(rows); ++s) {
    const float4 x = X[s * 32 + lane];
    const float4 y = Y[s * 32 + lane];
    const float4 z = Z[s * 32 + lane];
    const float d0 = p2_sqdist(qx, qy, qz, x.x, y.x, z.x);
    const float d1 = p2_sqdist(qx, qy, qz, x.y, y.y, z.y);
    const float d2 = p2_sqdist(qx, qy, qz, x.z, y.z, z.z);
    const float d3 = p2_sqdist(qx, qy, qz, x.w, y.w, z.w);
    const float r2 = rows[0].r2;
    const bool h0 = d0 < r2, h1 = d1 < r2, h2 = d2 < r2, h3 = d3 < r2;
    const unsigned m0 = __ballot_sync(0xffffffffu, h0);
    const unsigned m1 = __ballot_sync(0xffffffffu, h1);
    const unsigned m2 = __ballot_sync(0xffffffffu, h2);
    const unsigned m3 = __ballot_sync(0xffffffffu, h3);
    if ((m0 | m1 | m2 | m3) == 0u) continue;
    const int i = base + s * kStep + lane;
    append(m0, h0, i, lane, rows[0]);
    append(m1, h1, i + 32, lane, rows[0]);
    append(m2, h2, i + 64, lane, rows[0]);
    append(m3, h3, i + 96, lane, rows[0]);
    if constexpr (R == 2) {
      const float n2 = rows[1].r2;
      append(__ballot_sync(0xffffffffu, d0 < n2), d0 < n2, i, lane, rows[1]);
      append(__ballot_sync(0xffffffffu, d1 < n2), d1 < n2, i + 32, lane, rows[1]);
      append(__ballot_sync(0xffffffffu, d2 < n2), d2 < n2, i + 64, lane, rows[1]);
      append(__ballot_sync(0xffffffffu, d3 < n2), d3 < n2, i + 96, lane, rows[1]);
    }
  }
  return s;
}

// Scan `steps` steps of a staged tile for one query: R rows together while
// all are open, then the one-radius scan for the row still open.
template <int R>
__device__ __forceinline__ void scan(const float* tile, int pad, int steps, int base, float qx,
                                     float qy, float qz, int lane, Row* rows) {
  const int s = scan_steps<R>(tile, pad, 0, steps, base, qx, qy, qz, lane, rows);
  if constexpr (R == 2) {
    if (rows[0].cnt < rows[0].nsample) {
      scan_steps<1>(tile, pad, s, steps, base, qx, qy, qz, lane, rows);
    } else if (rows[1].cnt < rows[1].nsample) {
      scan_steps<1>(tile, pad, s, steps, base, qx, qy, qz, lane, rows + 1);
    }
  }
}

// Fill a query's row past its hits with its first hit (0 for an empty ball).
__device__ __forceinline__ void pad_row(int cnt, int first, int nsample, int lane, int* row) {
  for (int s = (cnt < nsample ? cnt : nsample) + lane; s < nsample; s += 32) row[s] = first;
}

// grid (blocks a row, B): block x of row b takes queries
// [x * per_block, min((x + 1) * per_block, M)); the row (pad floats a
// coordinate) in dynamic shared memory.
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ball_query_resident_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                               int N, int M, int pad, int per_block, BallRows<R> p) {
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
  for (;;) {
    int q = 0;
    if (lane == 0) q = atomicAdd(&next, 1);
    q = __shfl_sync(0xffffffffu, q, 0);
    if (q >= q1) break;
    const long long g = b * M + q;
    Row rows[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rows[r] = {__fmul_rn(p.radius[r], p.radius[r]), p.nsample[r], 0, 0, p.out[r] + g * p.nsample[r]};
    }
    scan<R>(pts, pad, pad / kStep, 0, new_xyz[3 * g], new_xyz[3 * g + 1], new_xyz[3 * g + 2], lane,
            rows);
#pragma unroll
    for (int r = 0; r < R; ++r) pad_row(rows[r].cnt, rows[r].first, rows[r].nsample, lane, rows[r].out);
  }
}

// grid (blocks a row, B) as above, per_block <= kMaxTiledQueries; two
// buffers of tile points (3 * tile floats each) in dynamic shared memory.
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ball_query_tiled_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                            int N, int M, int tile, int per_block, BallRows<R> p) {
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);
  __shared__ int cnts[R][kMaxTiledQueries];
  __shared__ int firsts[R][kMaxTiledQueries];
  const long long b = blockIdx.y;
  const int q0 = blockIdx.x * per_block;
  const int nq = ((q0 + per_block) < M ? (q0 + per_block) : M) - q0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < nq; k += blockDim.x) {
#pragma unroll
    for (int r = 0; r < R; ++r) cnts[r][k] = firsts[r][k] = 0;
  }
  const float* row_pts = xyz + b * N * 3;
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
      bool open = false;
#pragma unroll
      for (int r = 0; r < R; ++r) open |= cnts[r][k] < p.nsample[r];
      if (!open) continue;
      const long long g = b * M + q0 + k;
      Row rows[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rows[r] = {__fmul_rn(p.radius[r], p.radius[r]), p.nsample[r], cnts[r][k], firsts[r][k],
                   p.out[r] + g * p.nsample[r]};
      }
      scan<R>(buf, tile, (cnt_t + kStep - 1) / kStep, base, new_xyz[3 * g], new_xyz[3 * g + 1],
              new_xyz[3 * g + 2], lane, rows);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane == 0) {
          cnts[r][k] = rows[r].cnt;
          firsts[r][k] = rows[r].first;
        }
        alive |= rows[r].cnt < rows[r].nsample;
      }
    }
    // every warp is done with tile t before t + 2 refills its buffer; stop
    // once no query of the block wants more points
    if (!__syncthreads_or(alive)) break;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // a tile still in flight after an early stop
  for (int k = warp; k < nq; k += warps) {
    const long long g = b * M + q0 + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pad_row(cnts[r][k], firsts[r][k], p.nsample[r], lane, p.out[r] + g * p.nsample[r]);
    }
  }
}

// Launch the route for rows p with the card already current: tiled 0 is the
// resident route (tile = N rounded up to a multiple of 128), tiled 1 two
// buffers of tile points (a multiple of 128); warps a block and per_block
// queries a block from the wrappers' plan().
template <int R>
cudaError_t launch_ball_query(const float* xyz, const float* new_xyz, int B, int N, int M,
                              const BallRows<R>& p, int tiled, int tile, int warps, int per_block,
                              cudaStream_t s) {
  if (N <= 0 || B > 65535 || warps <= 0 || warps > kMaxWarps || per_block <= 0 || tile <= 0 ||
      tile % kStep != 0 || (tiled ? per_block > kMaxTiledQueries : tile < N)) {
    return cudaErrorInvalidValue;
  }
  for (int r = 0; r < R; ++r) {
    if (p.nsample[r] < 0) return cudaErrorInvalidValue;
  }
  static int resident_smem[kP2MaxDevices];
  static int tiled_smem[kP2MaxDevices];
  const size_t smem = (tiled ? 2 : 1) * 3 * sizeof(float) * static_cast<size_t>(tile);
  const dim3 grid((M + per_block - 1) / per_block, B);
  cudaError_t err;
  if (tiled) {
    err = p2_allow_smem(ball_query_tiled_kernel<R>, smem, tiled_smem);
    if (err != cudaSuccess) return err;
    ball_query_tiled_kernel<R><<<grid, warps * 32, smem, s>>>(xyz, new_xyz, N, M, tile, per_block, p);
  } else {
    err = p2_allow_smem(ball_query_resident_kernel<R>, smem, resident_smem);
    if (err != cudaSuccess) return err;
    ball_query_resident_kernel<R><<<grid, warps * 32, smem, s>>>(xyz, new_xyz, N, M, tile, per_block,
                                                                 p);
  }
  return cudaGetLastError();
}

}  // namespace
