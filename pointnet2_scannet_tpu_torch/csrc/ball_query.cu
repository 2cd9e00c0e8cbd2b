// Single-radius ball query, one warp per query.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
// (ball_query_pallas). Contract: the first nsample indices with
// d^2 < r^2 in ascending index order, r^2 = f32(r) * f32(r); a short row is
// padded with its first hit and an empty ball gives an all-zero row.
//
// Bound on the card: reads. Each query scans its row's points in index order
// until nsample hits, 12 bytes a point; at SA1 that is up to 32 x 1024 x 8192
// point reads, all served from L1/L2 because every query of a batch row reads
// the same 96 KiB. The TPU kernel materialised a (TM, N) distance tile and ran
// nsample masked-min passes over it; here the warp tests 32 consecutive points
// at once, __ballot_sync gives the hit mask and a popcount of the lanes below
// gives each hit its slot, so hits are appended in index order with no sort
// and the scan stops as soon as the row is full.
#include <cuda_runtime.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void ball_query_kernel(const float* __restrict__ xyz,
                                  const float* __restrict__ new_xyz, int N,
                                  long long queries, int M, float radius,
                                  int nsample, int* __restrict__ out) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= queries) return;  // uniform across the warp
  const long long b = q / M;
  const float* pts = xyz + b * N * 3;
  const float qx = new_xyz[3 * q];
  const float qy = new_xyz[3 * q + 1];
  const float qz = new_xyz[3 * q + 2];
  const float r2 = __fmul_rn(radius, radius);
  int* row = out + q * nsample;
  const unsigned below = (1u << lane) - 1u;

  int cnt = 0;
  int first = 0;
  for (int base = 0; base < N && cnt < nsample; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < N) {
      hit = p2_sqdist(qx, qy, qz, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]) < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask != 0u) {
      if (cnt == 0) first = base + __ffs(mask) - 1;
      const int slot = cnt + __popc(mask & below);
      if (hit && slot < nsample) row[slot] = i;
      cnt += __popc(mask);
    }
  }
  for (int s = (cnt < nsample ? cnt : nsample) + lane; s < nsample; s += 32) {
    row[s] = first;  // 0 when the ball is empty
  }
}

}  // namespace

extern "C" int p2_ball_query(const float* xyz, const float* new_xyz, int B,
                             int N, int M, float radius, int nsample, int* out,
                             void* stream) {
  const long long queries = static_cast<long long>(B) * M;
  if (queries <= 0 || nsample <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, N, queries, M, radius, nsample, out);
  return static_cast<int>(cudaGetLastError());
}
