"""Furthest-point sampling and index gathers (channels-last).

The contract is the JAX package's ops/sampling.py: FPS seeds index 0, keeps
a running min-distance (init 1e10), never picks |p|^2 <= 1e-3 by default, and
breaks argmax ties to the lowest index; gather_points is a plain row gather.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel, gather_kernel, on_cuda


def furthest_point_sample(
    xyz: torch.Tensor, npoint: int, *, skip_near_origin: bool = True
) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices into N."""
    if on_cuda(xyz):
        return fps_kernel.furthest_point_sample_cuda(
            xyz.contiguous(), npoint, skip_near_origin=skip_near_origin
        )
    return fps_kernel.furthest_point_sample_plain(
        xyz, npoint, skip_near_origin=skip_near_origin
    )


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) int32 -> (B, M, C)."""
    if on_cuda(points):
        return gather_kernel.gather_cuda(
            points.contiguous(), idx.to(torch.int32).contiguous()
        )
    return gather_kernel.gather_plain(points, idx)
