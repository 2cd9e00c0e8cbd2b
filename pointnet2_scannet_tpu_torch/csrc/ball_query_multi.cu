// Two-radius ball query (the MSG levels), one warp per query.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
// (ball_query_multi_pallas). Contract: two outputs, each equal bit for bit to
// the single-radius ball query (ball_query.cu) at its own (radius, nsample):
// the first nsample indices with d^2 < r^2 in ascending index order,
// r^2 = f32(r) * f32(r), a short row padded with its first hit, an empty ball
// all zeros. The two radii may come in either order.
//
// Bound on the card: point reads from L1/L2 and distance evaluations. The TPU
// kernel computed one (TM, N) distance tile and ran nsample masked-min passes
// per radius over it. Here a warp tests 32 consecutive points at a time,
// computes each d^2 once for both radii and takes one ballot per radius; each
// row is appended in index order as in ball_query.cu. The scan stops once
// both rows are full, so it runs as long as the radius that fills last needs:
// at SA1 that is the narrow one (0.05 m, 16 samples), which rarely fills, so
// most queries scan all N points, as one single-radius query at that radius
// would, and the wide radius rides along for one extra compare.
#include <cuda_runtime.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// Append this chunk's hits (mask: one bit per lane) to a row in index order.
__device__ __forceinline__ void append_hits(unsigned mask, bool hit, int base,
                                            int i, unsigned below, int nsample,
                                            int* row, int& cnt, int& first) {
  if (mask == 0u) return;
  if (cnt == 0) first = base + __ffs(mask) - 1;
  const int slot = cnt + __popc(mask & below);
  if (hit && slot < nsample) row[slot] = i;
  cnt += __popc(mask);
}

// Pad the row's tail with its first hit (0 when the ball is empty).
__device__ __forceinline__ void pad_row(int* row, int cnt, int first,
                                        int nsample, int lane) {
  for (int s = (cnt < nsample ? cnt : nsample) + lane; s < nsample; s += 32) {
    row[s] = first;
  }
}

__global__ void ball_query_multi_kernel(
    const float* __restrict__ xyz, const float* __restrict__ new_xyz, int N,
    long long queries, int M, float radius1, int nsample1, float radius2,
    int nsample2, int* __restrict__ out1, int* __restrict__ out2) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= queries) return;  // uniform across the warp
  const long long b = q / M;
  const float* pts = xyz + b * N * 3;
  const float qx = new_xyz[3 * q];
  const float qy = new_xyz[3 * q + 1];
  const float qz = new_xyz[3 * q + 2];
  const float r2a = __fmul_rn(radius1, radius1);
  const float r2b = __fmul_rn(radius2, radius2);
  int* row1 = out1 + q * nsample1;
  int* row2 = out2 + q * nsample2;
  const unsigned below = (1u << lane) - 1u;

  int cnt1 = 0, first1 = 0, cnt2 = 0, first2 = 0;
  // cnt1 and cnt2 come from ballots, so the loop condition is warp-uniform
  for (int base = 0; base < N && (cnt1 < nsample1 || cnt2 < nsample2);
       base += 32) {
    const int i = base + lane;
    bool hit1 = false, hit2 = false;
    if (i < N) {
      const float d2 =
          p2_sqdist(qx, qy, qz, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
      hit1 = d2 < r2a;
      hit2 = d2 < r2b;
    }
    const unsigned mask1 = __ballot_sync(0xffffffffu, hit1);
    const unsigned mask2 = __ballot_sync(0xffffffffu, hit2);
    append_hits(mask1, hit1, base, i, below, nsample1, row1, cnt1, first1);
    append_hits(mask2, hit2, base, i, below, nsample2, row2, cnt2, first2);
  }
  pad_row(row1, cnt1, first1, nsample1, lane);
  pad_row(row2, cnt2, first2, nsample2, lane);
}

}  // namespace

extern "C" int p2_ball_query_multi(const float* xyz, const float* new_xyz,
                                   int B, int N, int M, float radius1,
                                   int nsample1, float radius2, int nsample2,
                                   int* out1, int* out2, void* stream) {
  const long long queries = static_cast<long long>(B) * M;
  if (queries <= 0 || (nsample1 <= 0 && nsample2 <= 0)) {
    return static_cast<int>(cudaSuccess);
  }
  if (N <= 0 || nsample1 < 0 || nsample2 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_multi_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                            0, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, N, queries, M, radius1, nsample1, radius2, nsample2, out1,
      out2);
  return static_cast<int>(cudaGetLastError());
}
