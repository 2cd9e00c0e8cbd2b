"""Set abstraction (single scale) and feature propagation.

SetAbstraction: FPS -> gather the centroids -> ball query -> group
[xyz - centroid | features] -> pointwise MLP -> max over the K neighbours.
FeaturePropagation: 3-NN inverse-distance interpolation (weights
1/(sqrt(d2) + 1e-8), normalised) -> concat [interpolated, skip] -> MLP.
Both follow the JAX package's models/modules.py; every level, however small,
goes through the port's ops and so through the CUDA kernels on the card.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP


class SetAbstraction(nn.Module):
    """Single-scale grouping set abstraction; npoint=None groups all points."""

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
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if len(radii) != 1 or len(nsamples) != 1 or len(mlps) != 1:
            raise NotImplementedError(
                "multi-scale grouping (MSG) is not ported yet (ROADMAP queue 1, item 9)"
            )
        self.npoint = npoint
        self.radius = float(radii[0])
        self.nsample = int(nsamples[0])
        self.use_xyz = use_xyz
        self.mlp_0 = PointwiseMLP(
            in_channels + 3 * use_xyz, mlps[0], bn=bn, device=device
        )

    @property
    def out_channels(self) -> int:
        return self.mlp_0.widths[-1]

    def forward(
        self, xyz: torch.Tensor, features: torch.Tensor | None
    ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """(B, N, 3), (B, N, C) -> new_xyz (B, npoint, 3), (B, npoint, C')."""
        if self.npoint is None:
            new_xyz = None
            grouped = ops.group_all(xyz, features, use_xyz=self.use_xyz)
        else:
            idx = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, idx)
            nidx = ops.ball_query(self.radius, self.nsample, xyz, new_xyz)
            grouped = ops.group_with_idx(
                nidx, xyz, new_xyz, features, use_xyz=self.use_xyz
            )  # (B, M, K, 3 + C)
        return new_xyz, self.mlp_0(grouped).amax(dim=2)


class FeaturePropagation(nn.Module):
    """Upsample features from a coarse point set onto a dense one."""

    def __init__(
        self,
        mlp: Sequence[int],
        in_channels: int,
        *,
        bn: bool = True,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.mlp = PointwiseMLP(in_channels, mlp, bn=bn, device=device)

    def forward(
        self,
        unknown: torch.Tensor,
        known: torch.Tensor | None,
        unknown_feats: torch.Tensor | None,
        known_feats: torch.Tensor,
    ) -> torch.Tensor:
        """(B, n, 3), (B, m, 3), (B, n, C1), (B, m, C2) -> (B, n, mlp[-1])."""
        if known is not None:
            dist2, idx = ops.three_nn(unknown, known)
            recip = 1.0 / (torch.sqrt(dist2) + 1e-8)
            norm = (recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]
            interpolated = ops.three_interpolate(known_feats, idx, recip / norm)
        else:  # a global feature broadcast onto every point
            interpolated = known_feats.expand(-1, unknown.shape[1], -1)
        if unknown_feats is not None:
            h = torch.cat([interpolated, unknown_feats], dim=-1)
        else:
            h = interpolated
        return self.mlp(h)
