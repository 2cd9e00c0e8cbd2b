"""Ball query, grouping, and the query-and-group composition (channels-last).

The contract is the JAX package's ops/neighborhood.py: ball_query keeps the
first `nsample` in-radius indices in index order, pads a short row with its
first hit and an empty ball with zeros; ball_query_multi gives two such
selections (the MSG levels' two radii) from one distance pass; grouping
concatenates [xyz - centroid | features] on the channel axis. bfloat16
features are grouped as one packed [xyz_hi | xyz_lo | features] bfloat16
payload (split2_bf16), the centring done in float32.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.cuda import on_cuda
from pointnet2_scannet_tpu_torch.ops.sampling import gather_points

_HIGH_HALF = -65536  # 0xFFFF0000 as an int32: a float32 word's top 16 bits


def ball_query(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, M, nsample) int32 indices into N
    (pn2::ball_query)."""
    on_cuda(xyz)  # raises for a device with neither a kernel nor a plain version
    return torch.ops.pn2.ball_query.default(radius, nsample, xyz, new_xyz)


def ball_query_multi(
    radii: Sequence[float],
    nsamples: Sequence[int],
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two radii at once: (B, N, 3) x (B, M, 3) -> ((B, M, k1), (B, M, k2))
    int32, each equal to ball_query(radii[s], nsamples[s], xyz, new_xyz)
    (pn2::ball_query_multi)."""
    on_cuda(xyz)  # raises for a device with neither a kernel nor a plain version
    return torch.ops.pn2.ball_query_multi.default(
        [float(r) for r in radii], [int(k) for k in nsamples], xyz, new_xyz)


def group_points(
    points: torch.Tensor, idx: torch.Tensor, *, use_mxu: bool | None = None
) -> torch.Tensor:
    """(B, N, C) x (B, M, K) -> (B, M, K, C): gather_points over the M * K
    flattened indices, routed as it is."""
    B, M, K = idx.shape
    out = gather_points(points, idx.reshape(B, M * K), use_mxu=use_mxu)
    return out.reshape(B, M, K, points.shape[-1])


class _Split2BF16(torch.autograd.Function):
    """split2_bf16's forward and its VJP: hi carries no gradient (a step
    function), lo the whole of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        hi = (x.view(torch.int32) & _HIGH_HALF).view(torch.float32)
        return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, ghi: torch.Tensor, glo: torch.Tensor) -> torch.Tensor:
        return glo.to(torch.float32)


def split2_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) bfloat16, the JAX package's split2_bf16
    (neighborhood.py:172-196): hi is x's top 16 bits (truncation, not
    rounding), lo = x - hi rounded to bfloat16, so hi + lo keeps 16 bits of
    the mantissa. Its VJP is d(lo) alone: the caller re-adds hi + lo, and
    both would otherwise carry the same cotangent."""
    return _Split2BF16.apply(x.contiguous())


def group_with_idx(
    idx: torch.Tensor,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor | None,
    *,
    use_xyz: bool = True,
) -> torch.Tensor:
    """Group with precomputed neighbour indices: (B, M, K, 3 + C) for
    use_xyz with features, else (B, M, K, 3) or (B, M, K, C).

    bfloat16 features (with the packed_bf16_group switch, on by default)
    take one bfloat16 gather of [xyz_hi | xyz_lo | features] rows, half the
    bytes of the float32 payload the concatenation would promote to; the
    grouped xyz is rebuilt and centred in float32 before its cast, so it
    keeps bfloat16's full relative precision (neighborhood.py:212-231)."""
    if (features is not None and use_xyz and features.dtype == torch.bfloat16
            and tuning.ops_config.packed_bf16_group):
        hi, lo = split2_bf16(xyz.to(torch.float32))
        grouped = group_points(torch.cat([hi, lo, features], dim=-1), idx)
        gxyz = grouped[..., :3].float() + grouped[..., 3:6].float() - new_xyz[:, :, None, :]
        return torch.cat([gxyz.to(torch.bfloat16), grouped[..., 6:]], dim=-1)
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
