"""Ball query, grouping, and the query-and-group composition (channels-last).

The contract is the JAX package's ops/neighborhood.py: ball_query keeps the
first `nsample` in-radius indices in index order, pads a short row with its
first hit and an empty ball with zeros; ball_query_multi gives two such
selections (the MSG levels' two radii) from one distance pass;
unique_neighbor_count and uniform_resample_neighbors read that row layout
(the votenet modules' sample_uniformly); grouping
concatenates [xyz - centroid | features] on the channel axis. bfloat16
features are grouped as one packed [xyz_hi | xyz_lo | features] bfloat16
payload (split2_bf16), the centring done in float32. Under
ops_config.group_segsum the groupings take group_points_segsum, whose
backward is scatter_add.cu's card-wide sort route.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel, on_cuda, scatter_kernel
from pointnet2_scannet_tpu_torch.ops.sampling import gather_points

_HIGH_HALF = -65536  # 0xFFFF0000 as an int32: a float32 word's top 16 bits


def ball_query(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, *, dist_mode: str = "exact"
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, M, nsample) int32 indices into N
    (pn2::ball_query), on either of ops/tuning.ball_query_route's routes
    (both ball_query.cu on the card). dist_mode ("exact" or "dot",
    ops/common.pairwise_sqdist) is read by the plain version alone: the
    kernel computes the exact form, as the JAX package's Pallas route does."""
    cuda = on_cuda(xyz)  # raises for a device with neither a kernel nor a plain version
    route = tuning.ball_query_route(xyz.shape[1], new_xyz.shape[1], auto=cuda)
    tuning.route_counts["ball_query", route] += 1
    if dist_mode != "exact" and not cuda:
        return ball_query_kernel.ball_query_plain(radius, nsample, xyz, new_xyz, dist_mode)
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


class _GroupSegsum(torch.autograd.Function):
    """group_points' forward (routed as it is) with a sort-and-segment-sum
    backward: each flattened index row sorted, each source row's terms
    summed in ascending j in at least float32 and rounded once
    (scatter_add.cu's card-wide sort route; scatter_add_plain on the CPU)."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return group_points(points, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        B, M, K = idx.shape
        flat = idx.reshape(B, M * K)
        g = g.reshape(B, M * K, g.shape[-1]).contiguous()
        if on_cuda(g):
            return scatter_kernel.scatter_add_sorted_cuda(flat.to(torch.int32).contiguous(), g, ctx.n), None
        return scatter_kernel.scatter_add_plain(flat, g, ctx.n), None


def group_points_segsum(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """group_points with the JAX package's sort-and-segment-sum backward
    (neighborhood.py:315-347, read under ops_config.group_segsum): the same
    forward; the gradient the sorted rows' ordered sums, the same bits as
    group_points' backward in float32 and float64 (both sum each source
    row in ascending j). bfloat16 cotangents are summed in float32 and
    rounded once, where the JAX segment sum adds in bfloat16."""
    return _GroupSegsum.apply(points, idx)


def _grouping():
    segsum = tuning.ops_config.group_segsum
    tuning.route_counts["group", "segsum" if segsum else "gather"] += 1
    return group_points_segsum if segsum else group_points


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
    keeps bfloat16's full relative precision (neighborhood.py:212-231).
    Every branch groups through group_points_segsum under
    ops_config.group_segsum, else group_points (neighborhood.py:213)."""
    group = _grouping()
    if (features is not None and use_xyz and features.dtype == torch.bfloat16
            and tuning.ops_config.packed_bf16_group):
        hi, lo = split2_bf16(xyz.to(torch.float32))
        grouped = group(torch.cat([hi, lo, features], dim=-1), idx)
        gxyz = grouped[..., :3].float() + grouped[..., 3:6].float() - new_xyz[:, :, None, :]
        return torch.cat([gxyz.to(torch.bfloat16), grouped[..., 6:]], dim=-1)
    if features is not None and use_xyz:
        # one gather of the [xyz | features] rows, then centroid subtraction
        grouped = group(torch.cat([xyz, features], dim=-1), idx)
        grouped_xyz = grouped[..., :3] - new_xyz[:, :, None, :]
        return torch.cat([grouped_xyz, grouped[..., 3:]], dim=-1)
    if features is not None:
        return group(features, idx)
    if not use_xyz:
        raise ValueError("cannot have not features and not use xyz as a feature")
    return group(xyz, idx) - new_xyz[:, :, None, :]


def query_and_group(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor | None,
    *,
    use_xyz: bool = True,
    dist_mode: str = "exact",
) -> torch.Tensor:
    """Ball query (dist_mode as there), then group_with_idx around each
    query point."""
    idx = ball_query(radius, nsample, xyz, new_xyz, dist_mode=dist_mode)
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


def unique_neighbor_count(idx: torch.Tensor) -> torch.Tensor:
    """(B, M, K) ball-query indices -> (B, M) int32 distinct neighbours a row.

    Reads the ball query's row invariant: the distinct hits come first, in
    strictly ascending order, and the padding repeats the first hit. So the
    count is 1 + the length of the strictly ascending prefix of steps. The
    kernels keep that invariant, since ball_query.cu and ball_query_multi.cu
    are bit-equal to their plain versions. As in the JAX package
    (neighborhood.py:280), an empty ball (a row of zeros) counts as one."""
    increasing = (idx[..., 1:] > idx[..., :-1]).to(torch.int32)
    return (1 + torch.cumprod(increasing, dim=-1).sum(dim=-1)).to(torch.int32)


def uniform_resample_neighbors(
    idx: torch.Tensor, generator: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace each ball-query row's padding with uniform draws from the
    row's distinct neighbours (the JAX package's uniform_resample_neighbors,
    neighborhood.py:294): slot k keeps idx[k] where k < cnt, else takes
    idx[randint(0, 2**30) % cnt]. The draws come from generator, on its
    device (JAX's key stream cannot be matched). Returns (idx (B, M, K),
    cnt (B, M)), both int32."""
    cnt = unique_neighbor_count(idx)
    rand = torch.randint(0, 1 << 30, idx.shape, generator=generator, device=generator.device)
    pick = rand.to(idx.device) % cnt[..., None]
    resampled = torch.gather(idx, -1, pick)
    slots = torch.arange(idx.shape[-1], device=idx.device)
    out = torch.where(slots < cnt[..., None], idx, resampled)
    return out.to(torch.int32), cnt
