"""3-nearest-neighbour search and inverse-distance interpolation.

three_nn returns squared distances, ascending, lowest index on ties (the JAX
package's ops/interpolate.py). three_interpolate is the gather form
(interpolate.py:74-93): one gather_points of the 3n neighbour rows, so its
gradient is the same deterministic scatter-add as every other gather's, then
the weighted sum in plain PyTorch.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import on_cuda, three_nn_kernel
from pointnet2_scannet_tpu_torch.ops.sampling import gather_points


def three_nn(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3), m >= 3 -> (dist2 (B, n, 3), idx (B, n, 3) int32)."""
    if on_cuda(unknown):
        return three_nn_kernel.three_nn_cuda(unknown.contiguous(), known.contiguous())
    return three_nn_kernel.three_nn_plain(unknown, known)


def three_interpolate(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """(B, m, C) x (B, n, 3) x (B, n, 3) -> (B, n, C):
    out[b, j] = sum_i weight[b, j, i] * points[b, idx[b, j, i]]."""
    B, n, _ = idx.shape
    g = gather_points(points, idx.reshape(B, 3 * n)).reshape(B, n, 3, points.shape[-1])
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) + g[:, :, 2] * w[:, :, 2]
