"""Two-radius ball query (the MSG levels): the CUDA kernel
(csrc/ball_query_multi.cu) and its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
(ball_query_multi_pallas). Each of the two outputs equals the single-radius
ball query's (ball_query_kernel.py) at its own (radius, nsample), bit for
bit. On the card the op is bound by point reads served from L1/L2 and by
distance evaluations; the kernel is ball_query.cu's one-warp-per-query scan
with d^2 taken once per point for both radii and one ballot per radius,
stopping when both rows are full; see the note at the head of
csrc/ball_query_multi.cu.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.ball_query_kernel import first_hits

NAME = "ball_query_multi"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/ball_query_multi.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py:159"

launches = 0


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
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    out1, out2 = (torch.empty((B, M, k), dtype=torch.int32, device=xyz.device) for k in nsamples)
    if B * M == 0 or max(nsamples) == 0:
        return out1, out2
    if N == 0:
        raise ValueError("ball_query_multi_cuda needs at least one point")
    with torch.cuda.device(xyz.device):
        err = build.library().p2_ball_query_multi(
            build.ptr(xyz), build.ptr(new_xyz), B, N, M, radii[0], nsamples[0],
            radii[1], nsamples[1], build.ptr(out1), build.ptr(out2), build.stream_of(xyz),
        )
    build.check(err, NAME)
    launches += 1
    return out1, out2
