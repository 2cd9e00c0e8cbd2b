"""Ball query, grouping, and the query-and-group composition (channels-last).

The contract is the JAX package's ops/neighborhood.py: ball_query keeps the
first `nsample` in-radius indices in index order, pads a short row with its
first hit and an empty ball with zeros; ball_query_multi gives two such
selections (the MSG levels' two radii) from one distance pass; grouping
concatenates [xyz - centroid | features] on the channel axis.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel,
    ball_query_multi_kernel,
    on_cuda,
)
from pointnet2_scannet_tpu_torch.ops.sampling import gather_points


def ball_query(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, M, nsample) int32 indices into N."""
    if on_cuda(xyz):
        return ball_query_kernel.ball_query_cuda(
            radius, nsample, xyz.contiguous(), new_xyz.contiguous()
        )
    return ball_query_kernel.ball_query_plain(radius, nsample, xyz, new_xyz)


def ball_query_multi(
    radii: Sequence[float],
    nsamples: Sequence[int],
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two radii at once: (B, N, 3) x (B, M, 3) -> ((B, M, k1), (B, M, k2))
    int32, each equal to ball_query(radii[s], nsamples[s], xyz, new_xyz)."""
    if on_cuda(xyz):
        return ball_query_multi_kernel.ball_query_multi_cuda(
            radii, nsamples, xyz.contiguous(), new_xyz.contiguous()
        )
    return ball_query_multi_kernel.ball_query_multi_plain(radii, nsamples, xyz, new_xyz)


def group_points(
    points: torch.Tensor, idx: torch.Tensor, *, use_mxu: bool | None = None
) -> torch.Tensor:
    """(B, N, C) x (B, M, K) -> (B, M, K, C): gather_points over the M * K
    flattened indices, routed as it is."""
    B, M, K = idx.shape
    out = gather_points(points, idx.reshape(B, M * K), use_mxu=use_mxu)
    return out.reshape(B, M, K, points.shape[-1])


def group_with_idx(
    idx: torch.Tensor,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor | None,
    *,
    use_xyz: bool = True,
) -> torch.Tensor:
    """Group with precomputed neighbour indices: (B, M, K, 3 + C) for
    use_xyz with features, else (B, M, K, 3) or (B, M, K, C)."""
    if features is not None and use_xyz:
        # one gather of the [xyz | features] rows, then centroid subtraction
        grouped = group_points(torch.cat([xyz, features], dim=-1), idx)
        grouped_xyz = grouped[..., :3] - new_xyz[:, :, None, :]
        return torch.cat([grouped_xyz, grouped[..., 3:]], dim=-1)
    if features is not None:
        return group_points(features, idx)
    if not use_xyz:
        raise ValueError("cannot have not features and not use xyz as a feature")
    return group_points(xyz, idx) - new_xyz[:, :, None, :]


def query_and_group(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor | None,
    *,
    use_xyz: bool = True,
) -> torch.Tensor:
    """Ball query, then group_with_idx around each query point."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    return group_with_idx(idx, xyz, new_xyz, features, use_xyz=use_xyz)


def group_all(
    xyz: torch.Tensor, features: torch.Tensor | None, *, use_xyz: bool = True
) -> torch.Tensor:
    """The whole point set as one neighbourhood: (B, 1, N, 3 + C)."""
    grouped_xyz = xyz[:, None, :, :]
    if features is not None:
        grouped_features = features[:, None, :, :]
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=-1)
        return grouped_features
    return grouped_xyz
