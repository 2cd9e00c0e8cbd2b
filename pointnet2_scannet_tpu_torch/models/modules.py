"""Set abstraction (single and multi scale) and feature propagation.

SetAbstraction: FPS -> gather the centroids -> per scale (ball query ->
group [xyz - centroid | features] -> pointwise MLP -> max over the K
neighbours) -> concatenate the scales on channels. A two-scale (MSG) level
takes both scales' indices from one fused two-radius ball query.
FeaturePropagation: 3-NN inverse-distance interpolation (weights
1/(sqrt(d2) + 1e-8), normalised) -> concat [interpolated, skip] -> MLP.
The votenet modules (SetAbstractionVotes, SetAbstractionMSGVotes,
LearnableFeaturePropagationMSG, the JAX modules.py:240-433) take given FPS
indices, pool by max, mean or an RBF weight, resample each ball's padding
uniformly, and propagate features by grouping instead of 3-NN.
All follow the JAX package's models/modules.py; every level, however small,
goes through the port's ops and so through the CUDA kernels on the card.
With a compute dtype (bfloat16), the set abstraction casts its input
features to it before grouping (xyz stays float32, so FPS, the ball queries
and 3-NN see what they see in a float32 model), and every MLP computes in it. bn_group (the JAX modules' bn_axis_name)
reaches every MLP's BatchNorm (models/layers.py).

SetAbstraction and FeaturePropagation also take a tp_group (tensor
parallelism, models/layers.py): each tp rank runs the geometry (FPS, the
ball queries, 3-NN) whole and its channel shard of every MLP layer. A set
abstraction gathers a scale's channels after its max-pool over the K
neighbours (nsample times fewer bytes than before it), and a feature
propagation after its MLP, so MSG's concatenation of its scales, FP's of
its skip and every module's output see whole channels in their order.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP
from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.interpolate import interpolation


class SetAbstraction(nn.Module):
    """Set abstraction with one MLP per grouping scale (mlp_{s}); npoint=None
    groups all points (no radius or nsample, one MLP) and returns no
    new_xyz, as the JAX module does."""

    def __init__(
        self,
        npoint: int | None,
        radii: Sequence[float],
        nsamples: Sequence[int],
        mlps: Sequence[Sequence[int]],
        in_channels: int,
        *,
        use_xyz: bool = True,
        bn: bool = True,
        dtype: torch.dtype | None = None,
        bn_group=None,
        tp_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        scales = 1 if npoint is None else len(radii)  # group-all: one MLP, no radius
        if not (len(radii) == len(nsamples) and len(mlps) == scales > 0):
            raise ValueError(f"one radius, nsample and MLP per scale: {radii}, {nsamples}, {mlps}")
        self.npoint = npoint
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        self.use_xyz = use_xyz
        self.dtype = dtype
        for s, widths in enumerate(mlps):
            self.add_module(f"mlp_{s}", PointwiseMLP(
                in_channels + 3 * use_xyz, widths, bn=bn, dtype=dtype, bn_group=bn_group, tp_group=tp_group,
                device=device))

    def _mlps(self) -> list[PointwiseMLP]:
        return [getattr(self, f"mlp_{s}") for s in range(max(len(self.radii), 1))]

    @property
    def out_channels(self) -> int:
        return sum(mlp.widths[-1] for mlp in self._mlps())

    def forward(
        self,
        xyz: torch.Tensor,
        features: torch.Tensor | None,
        row_mask: torch.Tensor | None = None,
        bn_momentum=None,
    ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """(B, N, 3), (B, N, C) -> new_xyz (B, npoint, 3), (B, npoint, C');
        row_mask (B,) and bn_momentum reach every BatchNorm
        (PointwiseMLP.forward)."""
        if self.dtype is not None and features is not None:
            # before grouping, so that a bfloat16 model's SA1 takes the
            # packed bfloat16 grouping too (modules.py:62-66)
            features = features.to(self.dtype)
        if self.npoint is None:
            new_xyz = None
            grouped = ops.group_all(xyz, features, use_xyz=self.use_xyz)
            outs = [mlp.gather_channels(mlp(grouped, row_mask, bn_momentum, False).amax(dim=2))  # gather=False
                    for mlp in self._mlps()]
        else:
            idx = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, idx)
            outs = []
            for mlp, nidx in zip(self._mlps(), scale_indices(self.radii, self.nsamples, xyz, new_xyz)):
                if self._pregather(features, mlp.widths):
                    tuning.route_counts["pregather", self.npoint] += 1  # a scale of this level
                    h = mlp.pregather(
                        xyz if self.use_xyz else None, features, nidx,
                        new_xyz if self.use_xyz else None, row_mask, bn_momentum, False,  # gather=False
                    )
                else:
                    h = mlp(ops.group_with_idx(
                        nidx, xyz, new_xyz, features, use_xyz=self.use_xyz
                    ), row_mask, bn_momentum, False)  # grouped (B, M, K, 3 + C); gather=False
                outs.append(mlp.gather_channels(h.amax(dim=2)))  # under tp: the narrowest point
        return new_xyz, outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def _pregather(self, features: torch.Tensor | None, widths: Sequence[int]) -> bool:
        """The JAX package's gate (modules.py:111-136): never without
        features; else ops_config.pregather_dense where it is True or False,
        whatever the width or dtype; else (None) layer 0 before the gather
        for wide inputs, c_in >= 2 * widths[0], in float32, and in bfloat16
        in eval mode only (in training the packed grouping already halves
        the gather and the pregather's extra scatter loses); never in
        float64, where the parity tests pin the unfused composition."""
        if features is None:
            return False
        if tuning.ops_config.pregather_dense is not None:
            return tuning.ops_config.pregather_dense
        c_in = features.shape[-1] + 3 * self.use_xyz
        if c_in < 2 * widths[0]:
            return False
        if features.dtype == torch.float32:
            return True
        return features.dtype == torch.bfloat16 and not self.training


def scale_indices(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                  new_xyz: torch.Tensor) -> list[torch.Tensor]:
    """Ball-query indices per scale. Two scales take the fused two-radius
    query at every size: its outputs equal the single queries' by contract,
    and the JAX package's alignment condition (N % 128, M % 256) is about
    TPU tiles."""
    if len(radii) == 2:
        return list(ops.ball_query_multi(radii, nsamples, xyz, new_xyz))
    return [ops.ball_query(r, k, xyz, new_xyz) for r, k in zip(radii, nsamples)]


def _mlp_in(in_channels: int, use_xyz: bool) -> int:
    """Channels of a grouped neighbourhood: xyz beside the features under
    use_xyz, xyz alone without features."""
    return in_channels + 3 if use_xyz or in_channels == 0 else in_channels


def _resample(idx: torch.Tensor, generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
    if generator is None:
        raise ValueError("sample_uniformly needs a torch.Generator (forward(..., generator=...))")
    return ops.uniform_resample_neighbors(idx, generator)


class FeaturePropagation(nn.Module):
    """Upsample features from a coarse point set onto a dense one."""

    def __init__(
        self,
        mlp: Sequence[int],
        in_channels: int,
        *,
        bn: bool = True,
        dtype: torch.dtype | None = None,
        bn_group=None,
        tp_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.mlp = PointwiseMLP(in_channels, mlp, bn=bn, dtype=dtype, bn_group=bn_group, tp_group=tp_group,
                                device=device)

    def forward(
        self,
        unknown: torch.Tensor,
        known: torch.Tensor | None,
        unknown_feats: torch.Tensor | None,
        known_feats: torch.Tensor,
        row_mask: torch.Tensor | None = None,
        bn_momentum=None,
    ) -> torch.Tensor:
        """(B, n, 3), (B, m, 3), (B, n, C1), (B, m, C2) -> (B, n, mlp[-1]);
        row_mask and bn_momentum as in SetAbstraction.forward. The
        interpolation is the form ops/tuning.interpolate_route picks from
        the switches, in the JAX package's order (modules.py:207-223).
        bfloat16 known_feats interpolate in float32 in the gather and fast
        forms (the weights promote them), in bfloat16 in the dense ones (W
        takes their dtype), and the concatenation with bfloat16 skip
        features promotes to the wider dtype, as jnp does
        (modules.py:234-236); the MLP casts to its dtype."""
        if known is not None:
            dist2, idx = ops.three_nn(unknown, known)
            recip = 1.0 / (torch.sqrt(dist2) + 1e-8)
            norm = (recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]
            route = tuning.interpolate_route()
            tuning.route_counts["interpolate", route] += 1
            interpolated = interpolation(route)(known_feats, idx, recip / norm)
        else:  # a global feature broadcast onto every point
            interpolated = known_feats.expand(-1, unknown.shape[1], -1)
        if unknown_feats is not None:
            h = torch.cat([interpolated, unknown_feats], dim=-1)
        else:
            h = interpolated
        return self.mlp(h, row_mask, bn_momentum)


class SetAbstractionVotes(nn.Module):
    """Single-scale set abstraction of VoteNet's backbone and proposal
    module (the JAX SetAbstractionVotes, modules.py:240-326): FPS, or the
    caller's inds -> ball query (radius, nsample) -> group xyz - centroid
    (divided by radius under normalize_xyz) and the features, each its own
    gather -> MLP (mlp) -> pool over the K neighbours: "max", "avg", or
    "rbf" (sum weighted by exp(-|xyz|^2 / sigma^2 / 2), sigma radius / 2 by
    default, over nsample). sample_uniformly replaces each ball's padding
    with draws from its distinct neighbours (forward's generator);
    ret_unique_cnt also returns the distinct count a ball. npoint=None
    groups all points and returns no new_xyz or inds."""

    def __init__(
        self,
        mlp: Sequence[int],
        in_channels: int,
        *,
        npoint: int | None = None,
        radius: float | None = None,
        nsample: int | None = None,
        bn: bool = True,
        use_xyz: bool = True,
        pooling: str = "max",
        sigma: float | None = None,
        normalize_xyz: bool = False,
        sample_uniformly: bool = False,
        ret_unique_cnt: bool = False,
        dtype: torch.dtype | None = None,
        bn_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if pooling not in ("max", "avg", "rbf"):
            raise ValueError(f"unknown pooling {pooling!r}")
        if (npoint is not None or pooling == "rbf") and (radius is None or nsample is None):
            raise ValueError("a ball (npoint) and rbf pooling need radius and nsample")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz, self.pooling, self.normalize_xyz = use_xyz, pooling, normalize_xyz
        self.sigma = sigma if sigma is not None else (radius / 2.0 if radius is not None else None)
        self.sample_uniformly, self.ret_unique_cnt = sample_uniformly, ret_unique_cnt
        self.mlp = PointwiseMLP(_mlp_in(in_channels, use_xyz), mlp, bn=bn, dtype=dtype, bn_group=bn_group,
                                device=device)

    def forward(
        self,
        xyz: torch.Tensor,
        features: torch.Tensor | None = None,
        inds: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        bn_momentum=None,
    ) -> tuple:
        """(B, N, 3), (B, N, C), inds (B, npoint) int32 or None ->
        (new_xyz (B, npoint, 3), features (B, npoint, mlp[-1]), inds), and
        the distinct neighbour counts (B, npoint) under ret_unique_cnt."""
        unique_cnt = None
        if self.npoint is not None:
            if inds is None:
                inds = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, inds)
            idx = ops.ball_query(self.radius, self.nsample, xyz, new_xyz)
            if self.sample_uniformly:
                idx, unique_cnt = _resample(idx, generator)
            elif self.ret_unique_cnt:
                unique_cnt = ops.unique_neighbor_count(idx)
            # the grouped xyz before any concatenation: rbf weighs by it
            grouped_xyz = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if self.normalize_xyz:
                grouped_xyz = grouped_xyz / self.radius
            grouped = grouped_xyz
            if features is not None:
                grouped_feats = ops.group_points(features, idx)
                grouped = torch.cat([grouped_xyz, grouped_feats], dim=-1) if self.use_xyz else grouped_feats
        else:
            new_xyz = None
            grouped = ops.group_all(xyz, features, use_xyz=self.use_xyz)
            grouped_xyz = xyz[:, None, :, :]
        h = self.mlp(grouped, None, bn_momentum)
        if self.pooling == "max":
            pooled = h.amax(dim=2)
        elif self.pooling == "avg":
            pooled = h.mean(dim=2)
        else:
            rbf = torch.exp(-(grouped_xyz ** 2).sum(dim=-1) / (self.sigma ** 2) / 2.0)  # (B, M, K)
            pooled = (h * rbf[..., None]).sum(dim=2) / float(self.nsample)
        if self.ret_unique_cnt:
            return new_xyz, pooled, inds, unique_cnt
        return new_xyz, pooled, inds


class SetAbstractionMSGVotes(nn.Module):
    """Multi-scale set abstraction that takes the caller's FPS indices (the
    JAX SetAbstractionMSGVotes, modules.py:329-384): per scale, ball query
    (two scales: the fused two-radius query), optionally the uniform
    resampling, grouping [xyz - centroid | features], MLP mlp_{s}, max over
    the neighbours; the scales concatenated on channels."""

    def __init__(
        self,
        npoint: int | None,
        radii: Sequence[float],
        nsamples: Sequence[int],
        mlps: Sequence[Sequence[int]],
        in_channels: int,
        *,
        use_xyz: bool = True,
        bn: bool = True,
        sample_uniformly: bool = False,
        dtype: torch.dtype | None = None,
        bn_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if not (len(mlps) > 0 and (npoint is None or len(radii) == len(nsamples) == len(mlps))):
            raise ValueError(f"one radius, nsample and MLP per scale: {radii}, {nsamples}, {mlps}")
        self.npoint = npoint
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        self.scales = len(mlps)
        self.use_xyz, self.sample_uniformly = use_xyz, sample_uniformly
        for s, widths in enumerate(mlps):
            self.add_module(f"mlp_{s}", PointwiseMLP(
                _mlp_in(in_channels, use_xyz), widths, bn=bn, dtype=dtype, bn_group=bn_group, device=device))

    def forward(
        self,
        xyz: torch.Tensor,
        features: torch.Tensor | None = None,
        inds: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        bn_momentum=None,
    ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
        """(B, N, 3), (B, N, C), inds -> (new_xyz, (B, npoint, sum of
        mlps[s][-1]), inds); generator for sample_uniformly."""
        new_xyz = idxs = None
        if self.npoint is not None:
            if inds is None:
                inds = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, inds)
            idxs = scale_indices(self.radii, self.nsamples, xyz, new_xyz)
        outs = []
        for s in range(self.scales):
            if idxs is None:
                grouped = ops.group_all(xyz, features, use_xyz=self.use_xyz)
            else:
                idx = _resample(idxs[s], generator)[0] if self.sample_uniformly else idxs[s]
                grouped = ops.group_with_idx(idx, xyz, new_xyz, features, use_xyz=self.use_xyz)
            outs.append(getattr(self, f"mlp_{s}")(grouped, None, bn_momentum).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), inds


class LearnableFeaturePropagationMSG(nn.Module):
    """Feature propagation by grouping (the JAX
    LearnableFeaturePropagationMSG, modules.py:387-433): per scale, ball
    query of xyz1 around each point of xyz2, group [xyz1 - xyz2 | features1],
    MLP mlp_{s}, max over the neighbours, concatenate features2, then ONE
    post_mlp shared by every scale (its BatchNorm statistics move once a
    scale in train mode, as in the JAX module); the scales' outputs
    concatenated on channels. Every scale's MLP must end at one width, the
    post_mlp's input."""

    def __init__(
        self,
        mlps: Sequence[Sequence[int]],
        radii: Sequence[float],
        nsamples: Sequence[int],
        post_mlp: Sequence[int],
        in_channels1: int,
        in_channels2: int,
        *,
        use_xyz: bool = True,
        bn: bool = True,
        dtype: torch.dtype | None = None,
        bn_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if not (len(radii) == len(nsamples) == len(mlps) > 0):
            raise ValueError(f"one radius, nsample and MLP per scale: {radii}, {nsamples}, {mlps}")
        if len({widths[-1] for widths in mlps}) != 1:
            raise ValueError(f"the scales share post_mlp, so their MLPs must end at one width: {mlps}")
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        self.use_xyz = use_xyz
        for s, widths in enumerate(mlps):
            self.add_module(f"mlp_{s}", PointwiseMLP(
                _mlp_in(in_channels1, use_xyz), widths, bn=bn, dtype=dtype, bn_group=bn_group, device=device))
        self.post_mlp = PointwiseMLP(mlps[0][-1] + in_channels2, post_mlp, bn=bn, dtype=dtype,
                                     bn_group=bn_group, device=device)

    def forward(
        self,
        xyz2: torch.Tensor,
        xyz1: torch.Tensor,
        features2: torch.Tensor | None,
        features1: torch.Tensor | None,
        bn_momentum=None,
    ) -> torch.Tensor:
        """(B, N2, 3), (B, N1, 3), (B, N2, C2), (B, N1, C1) -> (B, N2,
        scales * post_mlp[-1])."""
        outs = []
        for s, idx in enumerate(scale_indices(self.radii, self.nsamples, xyz1, xyz2)):
            grouped = ops.group_with_idx(idx, xyz1, xyz2, features1, use_xyz=self.use_xyz)
            h = getattr(self, f"mlp_{s}")(grouped, None, bn_momentum).amax(dim=2)  # (B, N2, widths[-1])
            if features2 is not None:
                h = torch.cat([h, features2], dim=-1)
            outs.append(self.post_mlp(h, None, bn_momentum))
        return torch.cat(outs, dim=-1)
