"""The JAX package's one-hot MXU gathers (ops/pallas/gather_kernel.py), under
their public names, computed the card's way.

On the TPU these are exact gathers built as one-hot matrix products (the
TPU has no general gather) and their VJPs as the transposed products. The
port computes the same functions, on float32 and bfloat16 rows:
- mxu_gather: forward gather_smem.cu (e), backward scatter_smem.cu (f);
- mxu_gather_split: forward gather_smem.cu through its own wrapper (g),
  backward scatter_add.cu (h), as the JAX VJP is h;
- mxu_scatter_add: scatter_add.cu (h).
On the CPU each runs the kernels' plain versions. The float32 backwards sum
in ascending j, so the gradients equal the JAX VJPs up to the order in
which their products add (and bit for bit wherever a row collects one
term). On bfloat16 cotangents f follows the TPU kernel's order, whose
bfloat16 accumulator rounds once a 128-index tile, and h sums in float32
and rounds once, as the split VJP casts once: both equal the JAX VJPs bit
for bit at the shapes the tests draw. supported and scatter_supported are
the JAX package's shape gates.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import (
    gather_smem_kernel,
    gather_split_kernel,
    on_cuda,
    scatter_kernel,
    scatter_smem_kernel,
)
from pointnet2_scannet_tpu_torch.ops.tuning import mxu_scatter_supported as scatter_supported
from pointnet2_scannet_tpu_torch.ops.tuning import mxu_supported as supported

__all__ = ["mxu_gather", "mxu_gather_split", "mxu_scatter_add", "supported", "scatter_supported"]


class _MxuGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = src.shape[1]
        if on_cuda(src):
            return gather_smem_kernel.gather_smem_cuda(src.contiguous(), idx)
        return gather_smem_kernel.gather_smem_plain(src, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        grad = grad.contiguous()
        if on_cuda(grad):
            return scatter_smem_kernel.scatter_smem_cuda(idx, grad, ctx.n), None
        return scatter_smem_kernel.scatter_smem_plain(idx, grad, ctx.n), None


class _MxuGatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = src.shape[1]
        if on_cuda(src):
            return gather_split_kernel.gather_split_cuda(src.contiguous(), idx)
        return gather_split_kernel.gather_split_plain(src, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return mxu_scatter_add(idx, grad.contiguous(), ctx.n), None


def _index(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int32).contiguous() if on_cuda(src) else idx


def mxu_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int -> (B, J, C), differentiable in src."""
    return _MxuGather.apply(src, _index(src, idx))


def mxu_gather_split(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32/bfloat16 x (B, J) int -> (B, J, C), differentiable
    in src."""
    return _MxuGatherSplit.apply(src, _index(src, idx))


def mxu_scatter_add(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """dsrc[b, idx[b, j], :] += g[b, j, :] over ascending j: (B, J) x
    (B, J, C) -> (B, n, C)."""
    if on_cuda(g):
        return scatter_kernel.scatter_add_cuda(_index(g, idx), g.contiguous(), n)
    return scatter_kernel.scatter_add_plain(idx, g, n)
