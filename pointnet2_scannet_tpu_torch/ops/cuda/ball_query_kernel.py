"""Single-radius ball query: the CUDA kernel (csrc/ball_query.cu) and its
plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
(ball_query_pallas). On the card the op is bound by point reads served from
L1/L2 (every query of a batch row scans the same row). The kernel gives each
query one warp that tests 32 points at a time and appends hits in index order
with a ballot and a popcount, stopping once the row is full; see the note at
the head of csrc/ball_query.cu.
"""

from __future__ import annotations

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "ball_query"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/ball_query.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py:80"

launches = 0


def ball_query_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, M, nsample) int32; see first_hits."""
    return first_hits(pairwise_sqdist(new_xyz, xyz), radius, nsample)


def first_hits(d2: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """(B, M, N) squared distances -> (B, M, nsample) int32.

    The first `nsample` indices with d^2 < r^2 in ascending order, the row
    padded with its first hit, all zeros for an empty ball. r^2 is taken in
    the distance dtype: f32(r) * f32(r) for float32, as the TPU kernel does.
    """
    N = d2.shape[-1]
    np_dt = np.float64 if d2.dtype == torch.float64 else np.float32
    r = np_dt(radius)
    valid = d2 < torch.tensor(r * r, dtype=d2.dtype, device=d2.device)
    iota = torch.arange(N, dtype=torch.int32, device=d2.device)
    sentinel = torch.tensor(N, dtype=torch.int32, device=d2.device)
    masked = torch.where(valid, iota, sentinel)
    k = min(nsample, N)
    # the values are the candidate indices themselves, so the k smallest in
    # ascending order are the first k hits whatever order topk gives to ties
    idx = torch.topk(masked, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        pad = sentinel.expand(*idx.shape[:-1], nsample - k)
        idx = torch.cat([idx, pad], dim=-1)
    first = idx[..., :1]
    fill = torch.where(first < N, first, torch.zeros_like(first))
    return torch.where(idx < N, idx, fill)


def ball_query_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) float32 on the card -> (B, M, nsample) int32;
    launches ball_query.cu."""
    global launches
    build.require(xyz, "xyz", (torch.float32,), 3, 3)
    build.require(new_xyz, "new_xyz", (torch.float32,), 3, 3)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    out = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    if B * M == 0 or nsample == 0:
        return out
    if N == 0:
        raise ValueError("ball_query_cuda needs at least one point")
    with torch.cuda.device(xyz.device):
        err = build.library().p2_ball_query(
            build.ptr(xyz), build.ptr(new_xyz), B, N, M, float(radius),
            nsample, build.ptr(out), build.stream_of(xyz),
        )
    build.check(err, NAME)
    launches += 1
    return out
