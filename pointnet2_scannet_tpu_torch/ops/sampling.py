"""Furthest-point sampling and index gathers (channels-last).

The contract is the JAX package's ops/sampling.py: FPS seeds index 0, keeps
a running min-distance (init 1e10), never picks |p|^2 <= 1e-3 by default, and
breaks argmax ties to the lowest index; gather_points is a plain row gather
whose gradient is the deterministic scatter-add (the JAX package's
vmem_gather custom_vjp, vmem_gather_kernel.py:111-151), routed as the JAX
package routes it (ops/tuning.gather_route): its "mxu" route runs
ops/mxu_gather.mxu_gather, the others gather_rows. gather_rows takes
float32, float64, int32 and bfloat16 rows (a bfloat16 gradient is summed in
float32 and rounded once); the "mxu" route takes float32 and bfloat16 rows
(a bfloat16 gradient rounded once a 128-index tile, as the TPU kernel's
bfloat16 accumulator).
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.cuda import on_cuda, scatter_kernel
from pointnet2_scannet_tpu_torch.ops.mxu_gather import mxu_gather


def furthest_point_sample(
    xyz: torch.Tensor, npoint: int, *, skip_near_origin: bool = True
) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices into N (pn2::furthest_point_sample),
    on either of ops/tuning.fps_route's routes (both fps.cu on the card)."""
    route = tuning.fps_route(xyz.shape[1], auto=on_cuda(xyz))  # on_cuda raises for other devices
    tuning.route_counts["fps", route] += 1
    return torch.ops.pn2.furthest_point_sample.default(xyz, npoint, skip_near_origin)


class _GatherPoints(torch.autograd.Function):
    """Row gather; backward sums each output row's gradient back onto its
    source row in ascending output order (scatter_add.cu on the card)."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return torch.ops.pn2.gather.default(points, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        grad = grad.contiguous()
        if on_cuda(grad):
            return scatter_kernel.scatter_add_cuda(idx, grad, ctx.n), None
        return scatter_kernel.scatter_add_plain(idx, grad, ctx.n), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) int32 -> (B, M, C), differentiable in points:
    gather.cu forward, scatter_add.cu backward, whatever the switches (the
    JAX package's take_along_axis, which three_interpolate calls)."""
    if on_cuda(points):
        idx = idx.to(torch.int32).contiguous()
    return _GatherPoints.apply(points, idx)


def gather_points(
    points: torch.Tensor, idx: torch.Tensor, *, use_mxu: bool | None = None
) -> torch.Tensor:
    """(B, N, C) x (B, M) int32 -> (B, M, C), differentiable in points.
    use_mxu as in the JAX package: True pins the MXU gather where its gate
    admits the shape, False the plain gather, None follows ops_config."""
    route = tuning.gather_route(
        points.shape[1], idx.shape[1], points.shape[-1], points.dtype, use_mxu,
        auto=on_cuda(points),
    )
    tuning.route_counts["gather", route] += 1
    if route == "mxu":
        return mxu_gather(points, idx)
    return gather_rows(points, idx)
