"""Set abstraction (single and multi scale) and feature propagation.

SetAbstraction: FPS -> gather the centroids -> per scale (ball query ->
group [xyz - centroid | features] -> pointwise MLP -> max over the K
neighbours) -> concatenate the scales on channels. A two-scale (MSG) level
takes both scales' indices from one fused two-radius ball query.
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
    """Set abstraction with one MLP per grouping scale (mlp_{s}); npoint=None
    groups all points."""

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
        if not len(radii) == len(nsamples) == len(mlps) > 0:
            raise ValueError(f"one radius, nsample and MLP per scale: {radii}, {nsamples}, {mlps}")
        self.npoint = npoint
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        self.use_xyz = use_xyz
        for s, widths in enumerate(mlps):
            self.add_module(
                f"mlp_{s}", PointwiseMLP(in_channels + 3 * use_xyz, widths, bn=bn, device=device)
            )

    def _mlps(self) -> list[PointwiseMLP]:
        return [getattr(self, f"mlp_{s}") for s in range(len(self.radii))]

    @property
    def out_channels(self) -> int:
        return sum(mlp.widths[-1] for mlp in self._mlps())

    def forward(
        self,
        xyz: torch.Tensor,
        features: torch.Tensor | None,
        row_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """(B, N, 3), (B, N, C) -> new_xyz (B, npoint, 3), (B, npoint, C');
        row_mask (B,) reaches every BatchNorm (PointwiseMLP.forward)."""
        if self.npoint is None:
            new_xyz = None
            grouped = ops.group_all(xyz, features, use_xyz=self.use_xyz)
            outs = [mlp(grouped, row_mask).amax(dim=2) for mlp in self._mlps()]
        else:
            idx = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, idx)
            outs = []
            for mlp, nidx in zip(self._mlps(), self._scale_indices(xyz, new_xyz)):
                if self._pregather(features, mlp.widths):
                    h = mlp.pregather(
                        xyz if self.use_xyz else None, features, nidx,
                        new_xyz if self.use_xyz else None, row_mask,
                    )
                else:
                    h = mlp(ops.group_with_idx(
                        nidx, xyz, new_xyz, features, use_xyz=self.use_xyz
                    ), row_mask)  # grouped (B, M, K, 3 + C)
                outs.append(h.amax(dim=2))
        return new_xyz, outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def _pregather(self, features: torch.Tensor | None, widths: Sequence[int]) -> bool:
        """The JAX package's gate (modules.py:111-136): layer 0 before the
        gather for wide inputs, c_in >= 2 * widths[0], in float32; never
        without features or in float64, where the parity tests pin the
        unfused composition. (The JAX gate's bfloat16 case is not ported.)"""
        if features is None:
            return False
        c_in = features.shape[-1] + 3 * self.use_xyz
        return c_in >= 2 * widths[0] and features.dtype == torch.float32

    def _scale_indices(self, xyz: torch.Tensor, new_xyz: torch.Tensor) -> list[torch.Tensor]:
        """Ball-query indices per scale. A two-scale level takes the fused
        two-radius query at every size: its outputs equal the single
        queries' by contract, and the JAX package's alignment condition
        (N % 128, M % 256) is about TPU tiles."""
        if len(self.radii) == 2:
            return list(ops.ball_query_multi(self.radii, self.nsamples, xyz, new_xyz))
        return [ops.ball_query(r, k, xyz, new_xyz) for r, k in zip(self.radii, self.nsamples)]


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
        row_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(B, n, 3), (B, m, 3), (B, n, C1), (B, m, C2) -> (B, n, mlp[-1]);
        row_mask as in SetAbstraction.forward."""
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
        return self.mlp(h, row_mask)
