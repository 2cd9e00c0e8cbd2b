// Single-radius ball query: one warp per query at a time, the batch row's
// points staged in shared memory (ball_scan.cuh with R = 1).
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
// nsample masked-min passes over it; here a warp tests 128 points a step
// from the row staged in shared memory, appends hits in index order by
// ballots and popcounts and stops once the row is full. The scan, its
// staging and its two routes (the row resident in shared memory, or two
// cp.async tiles) are ball_scan.cuh's, shared with the two-radius query;
// ball_query_kernel.plan() picks the route.
#include "ball_scan.cuh"
#include "on_device.cuh"

// xyz (B, N, 3), new_xyz (B, M, 3) float32 -> out (B, M, nsample) int32.
// tiled 0: the resident route, tile = N rounded up to a multiple of 128;
// tiled 1: two buffers of tile points (a multiple of 128). warps a block,
// per_block queries a block: ball_query_kernel.plan(). device: the card
// that holds the tensors.
extern "C" int p2_ball_query(const float* xyz, const float* new_xyz, int B, int N, int M,
                             float radius, int nsample, int tiled, int tile, int warps,
                             int per_block, int* out, int device, void* stream) {
  if (static_cast<long long>(B) * M <= 0 || nsample <= 0) return static_cast<int>(cudaSuccess);
  const BallRows<1> rows = {{radius}, {nsample}, {out}};
  return static_cast<int>(p2_on_device(device, [&] {
    return launch_ball_query<1>(xyz, new_xyz, B, N, M, rows, tiled, tile, warps, per_block,
                                static_cast<cudaStream_t>(stream));
  }));
}
