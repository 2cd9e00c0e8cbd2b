"""3-nearest-neighbour search and inverse-distance interpolation.

three_nn returns squared distances, ascending, lowest index on ties (the JAX
package's ops/interpolate.py), routed by ops/tuning.three_nn_route: the
query-major route (three_nn_q_kernel, which runs three_nn.cu under its own
launch counter) where the JAX package takes its query-major Pallas kernel,
three_nn_kernel everywhere else.

The interpolation out[b, j] = sum_i weight[b, j, i] * points[b, idx[b, j, i]]
has the JAX package's four forms, among which FeaturePropagation picks by
ops/tuning.interpolate_route:
- three_interpolate, the gather form (interpolate.py:74-93): one
  gather_rows of the 3n neighbour rows (gather.cu on the card), so its
  gradient is the same deterministic scatter-add as every other gather's,
  then the weighted sum in plain PyTorch;
- three_interpolate_dense (:153-171): the operator W (B, n, m) built in
  points' dtype by scattering the three weights of a row into zeros, then
  one product W @ points; plain autograd, the weight differentiable;
- three_interpolate_cached (:174-213): the same forward saving W, whose
  backward is one product W^T @ g, nothing for idx or weight;
- three_interpolate_fast (:96-150): the gather form's forward (gather.cu
  on the card), a dense W^T @ g backward, nothing for idx or weight.
The dense products are stock batched matrix products (bmm), as the JAX
package computes them with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.cuda import on_cuda, three_nn_kernel
from pointnet2_scannet_tpu_torch.ops.sampling import gather_rows


def three_nn(
    unknown: torch.Tensor, known: torch.Tensor, *, dist_mode: str = "exact"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3), m >= 3 -> (dist2 (B, n, 3), idx (B, n, 3) int32).
    dist_mode ("exact" or "dot", ops/common.pairwise_sqdist) is read by the
    plain version alone: the kernels compute the exact form, as the JAX
    package's Pallas routes do."""
    route = tuning.three_nn_route(unknown.shape[1], known.shape[1], auto=on_cuda(unknown))
    tuning.route_counts["three_nn", route] += 1
    if dist_mode != "exact" and not on_cuda(unknown):
        return three_nn_kernel.three_nn_plain(unknown, known, dist_mode)
    if route == "q":
        return torch.ops.pn2.three_nn_q.default(unknown, known)
    return torch.ops.pn2.three_nn.default(unknown, known)


def three_interpolate(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """(B, m, C) x (B, n, 3) x (B, n, 3) -> (B, n, C):
    out[b, j] = sum_i weight[b, j, i] * points[b, idx[b, j, i]]."""
    B, n, _ = idx.shape
    g = gather_rows(points, idx.reshape(B, 3 * n)).reshape(B, n, 3, points.shape[-1])
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) + g[:, :, 2] * w[:, :, 2]


def dense_operator(idx: torch.Tensor, weight: torch.Tensor, m: int) -> torch.Tensor:
    """(B, n, 3) x (B, n, 3) -> W (B, n, m) of weight's dtype, three
    weights a row and zeros elsewhere: the JAX package's _dense_operator
    (interpolate.py:96-103) without its (B, n, 3, m) one-hot. three_nn's
    three indices of a row are distinct, so each entry is one weight,
    exactly; a repeated index adds its weights, as the one-hot sum does.
    Differentiable in weight."""
    B, n, _ = idx.shape
    zeros = torch.zeros((B, n, m), dtype=weight.dtype, device=weight.device)
    return zeros.scatter_add(2, idx.long(), weight)


def three_interpolate_dense(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """three_interpolate as one dense product W @ points, W built in
    points' dtype; differentiable in points and weight."""
    return torch.bmm(dense_operator(idx, weight.to(points.dtype), points.shape[1]), points)


class _CachedInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        w = dense_operator(idx, weight.to(points.dtype), points.shape[1])
        ctx.save_for_backward(w)
        return torch.bmm(w, points)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (w,) = ctx.saved_tensors
        return torch.bmm(w.transpose(1, 2), g.to(w.dtype)), None, None


def three_interpolate_cached(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """three_interpolate_dense saving W for the backward, which is one
    product W^T @ g (g cast to W's dtype) and gives idx and weight no
    gradient (the reference's ThreeInterpolate.backward contract)."""
    return _CachedInterpolate.apply(points, idx, weight)


class _FastInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx, weight)
        ctx.m, ctx.dtype = points.shape[1], points.dtype
        return three_interpolate(points, idx, weight)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        idx, weight = ctx.saved_tensors
        w = dense_operator(idx, weight.to(g.dtype), ctx.m)
        return torch.bmm(w.transpose(1, 2), g).to(ctx.dtype), None, None


def three_interpolate_fast(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """The gather form's forward (gather.cu on the card, no gradient
    recorded) with a dense backward W^T @ g, W built from weight cast to
    g's dtype and the result cast to points' dtype; idx and weight get no
    gradient (the reference's ThreeInterpolate.backward contract)."""
    return _FastInterpolate.apply(points, idx, weight)


def interpolation(route: str):
    """The function of an ops/tuning.interpolate_route route ("gather",
    "dense", "cached" or "fast"), looked up on the ops package when called."""
    from pointnet2_scannet_tpu_torch import ops

    return getattr(ops, "three_interpolate" if route == "gather" else f"three_interpolate_{route}")
