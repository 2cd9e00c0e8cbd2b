// Two-radius ball query (the MSG levels): one warp per query at a time, the
// batch row's points staged in shared memory (ball_scan.cuh with R = 2).
//
// Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
// (ball_query_multi_pallas). Contract: two outputs, each equal bit for bit to
// the single-radius ball query (ball_query.cu) at its own (radius, nsample):
// the first nsample indices with d^2 < r^2 in ascending index order,
// r^2 = f32(r) * f32(r), a short row padded with its first hit, an empty ball
// all zeros. The two radii may come in either order.
//
// Bound on the card: instruction issue, as for ball_query.cu, over the
// points a query's scan reads until both rows are full: at MSG's SA1 that is
// nearly the whole row, since the narrow radius (0.05 m, 16 samples) rarely
// fills. The TPU kernel computed one (TM, N) distance tile and ran nsample
// masked-min passes per radius over it. Here the scan is ball_query.cu's
// (the row in shared memory as permuted x/y/z arrays, 128 points a
// warp-step, one ballot per 32 points), with d^2 taken once per point for
// both radii: a step costs the wide radius's four ballots, and the narrow
// radius's only where the wide one hit, since the narrow hits are a subset
// of the wide ones. Once one row is full the warp goes on with the
// one-radius scan for the other. ball_query_multi_kernel.plan() picks the
// route (the row resident in shared memory, or two cp.async tiles) and the
// grid.
#include "ball_scan.cuh"
#include "on_device.cuh"

// xyz (B, N, 3), new_xyz (B, M, 3) float32 -> out1 (B, M, nsample1) and
// out2 (B, M, nsample2) int32, radius1 and radius2 in either order. tiled,
// tile, warps and per_block as for p2_ball_query, from
// ball_query_multi_kernel.plan(). device: the card that holds the tensors.
extern "C" int p2_ball_query_multi(const float* xyz, const float* new_xyz, int B, int N, int M,
                                   float radius1, int nsample1, float radius2, int nsample2,
                                   int tiled, int tile, int warps, int per_block, int* out1,
                                   int* out2, int device, void* stream) {
  if (static_cast<long long>(B) * M <= 0 || (nsample1 <= 0 && nsample2 <= 0)) {
    return static_cast<int>(cudaSuccess);
  }
  // row 0 takes the wider radius: its ballots decide whether a step holds a hit
  const bool swap = radius2 * radius2 > radius1 * radius1;
  const BallRows<2> rows = swap ? BallRows<2>{{radius2, radius1}, {nsample2, nsample1}, {out2, out1}}
                                : BallRows<2>{{radius1, radius2}, {nsample1, nsample2}, {out1, out2}};
  return static_cast<int>(p2_on_device(device, [&] {
    return launch_ball_query<2>(xyz, new_xyz, B, N, M, rows, tiled, tile, warps, per_block,
                                static_cast<cudaStream_t>(stream));
  }));
}
