"""Two-radius ball query (the MSG levels): the CUDA kernel
(csrc/ball_query_multi.cu) and its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
(ball_query_multi_pallas). Each of the two outputs equals the single-radius
ball query's (ball_query_kernel.py) at its own (radius, nsample), bit for
bit. On the card the op is bound by instruction issue over the points a
query scans until both rows are full. The kernel is ball_query.cu's scan
(csrc/ball_scan.cuh) for two rows: the batch row staged in shared memory,
d^2 taken once per point for both radii, the narrow radius's ballots taken
only in steps where the wide one hits, and the one-radius scan for the row
still open once the other is full. plan() is the single-radius query's,
with the second row's counts in the tiled route's shared memory; see the
notes at the head of csrc/ball_query_multi.cu and csrc/ball_scan.cuh.
"""

from __future__ import annotations

import functools
from collections.abc import Sequence

import torch

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.ball_query_kernel import first_hits

NAME = "ball_query_multi"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/ball_query_multi.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py:159"
RADII = 2  # rows a query fills

launches = 0


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, m: int, sms: int) -> bq.Plan:
    """The launch for (b, n) points and (b, m) queries on a card of sms
    multiprocessors, by ball_query_kernel.plan()'s rule: the resident route
    up to RESIDENT_POINTS points a row, the tiled one above, WARPS warps a
    block, blocks that fill the multiprocessors WAVES times; the tiled
    route's shared memory holds both rows' counts."""
    route = "resident" if n <= bq.RESIDENT_POINTS else "tiled"
    return bq.route_plan(b, n, m, sms, route, bq.WARPS, radii=RADII)


def candidate_plans(b: int, n: int, m: int, sms: int) -> list:
    """Launch shapes to profile, as ball_query_kernel.candidate_plans()."""
    return bq.candidate_plans(b, n, m, sms, radii=RADII)


def _pairs(radii: Sequence[float], nsamples: Sequence[int]) -> tuple[tuple, tuple]:
    if len(radii) != 2 or len(nsamples) != 2:
        raise ValueError(f"two radii and two nsamples, got {radii} and {nsamples}")
    return tuple(float(r) for r in radii), tuple(int(k) for k in nsamples)


def ball_query_multi_plain(
    radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) x (B, M, 3) -> ((B, M, k1), (B, M, k2)) int32: the (B, M, N)
    distances once, then the first hits of each radius."""
    radii, nsamples = _pairs(radii, nsamples)
    d2 = pairwise_sqdist(new_xyz, xyz)
    return first_hits(d2, radii[0], nsamples[0]), first_hits(d2, radii[1], nsamples[1])


def launch(radii: tuple, nsamples: tuple, xyz: torch.Tensor, new_xyz: torch.Tensor,
           outs: tuple, p: bq.Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """ball_query_multi.cu with plan p into outs ((B, M, k1), (B, M, k2)) on
    checked tensors. Counts no launch: ball_query_multi_cuda does."""
    B, N, _ = xyz.shape
    err = build.library().p2_ball_query_multi(
        xyz.data_ptr(), new_xyz.data_ptr(), B, N, new_xyz.shape[1], radii[0], nsamples[0],
        radii[1], nsamples[1], int(p.route == "tiled"), p.tile, p.warps, p.per_block,
        outs[0].data_ptr(), outs[1].data_ptr(), xyz.get_device(), build.stream_of(xyz))
    build.check(err, NAME)
    return outs


def ball_query_multi_cuda(
    radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) x (B, M, 3) float32 on the card -> ((B, M, k1), (B, M, k2))
    int32; launches ball_query_multi.cu."""
    global launches
    radii, nsamples = _pairs(radii, nsamples)
    build.require(xyz, "xyz", (torch.float32,), 3, 3)
    build.require(new_xyz, "new_xyz", (torch.float32,), 3, 3)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.get_device() != xyz.get_device():
        raise ValueError("xyz and new_xyz must share batch size and device")
    build.check_batch(B, NAME)
    outs = tuple(torch.empty((B, M, k), dtype=torch.int32, device=xyz.device) for k in nsamples)
    if B * M == 0 or max(nsamples) == 0:
        return outs
    if N == 0:
        raise ValueError("ball_query_multi_cuda needs at least one point")
    launch(radii, nsamples, xyz, new_xyz, outs, plan(B, N, M, build.sm_count(xyz)))
    launches += 1
    return outs
