"""The kernels that a serving forward launches, as torch.library ops (pn2::).

One op per kernel, so that torch.export traces each kernel call as one graph
node (its fake impl gives shapes and dtypes) and a saved program calls the
same kernel when it runs:

    op                       kernel  wrapper (card)                                  output
    pn2::furthest_point_sample  a    fps_kernel.furthest_point_sample_cuda           (B, npoint) int32
    pn2::ball_query             b    ball_query_kernel.ball_query_cuda               (B, M, k) int32
    pn2::ball_query_multi       c    ball_query_multi_kernel.ball_query_multi_cuda   two (B, M, k_s) int32
    pn2::gather                 d    gather_kernel.gather_cuda                       (B, J, C) src.dtype
    pn2::gather_smem            e    gather_smem_kernel.gather_smem_cuda             (B, J, C) src.dtype
    pn2::three_nn               i    three_nn_kernel.three_nn_cuda                   (dist2, idx int32)
    pn2::three_nn_q             j    three_nn_q_kernel.three_nn_q_cuda               (dist2, idx int32)

Each op has one device-agnostic impl: the kernel's wrapper where the public
op's module says the tensor lies on the card (its `on_cuda`, looked up at
call time), the plain version otherwise. The wrapper launches its kernel or
raises; nothing falls back. The launch counters count inside the wrappers,
so tracing (which runs only the fake impls) counts nothing. The backwards
(h, f), the split gather g and the fused gather-matmul k have no op: no
serving forward reaches them, and they stay direct calls.

The ops are defined with torch.library.Library's define / impl and
register_fake rather than torch.library.custom_op, which would add a Python
autograd layer (host time) to every call and refuse a backward through an
op. Here autograd falls through to the impl, so each op differentiates as
its public op did before: the plain dist2 of 3-NN keeps its gradient on the
CPU, and the kernels' outputs carry none on the card.

Importing pointnet2_scannet_tpu_torch.ops registers them; an exported
program that holds them needs that import before torch.export.load.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops import interpolate, mxu_gather, neighborhood, sampling
from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel,
    ball_query_multi_kernel,
    fps_kernel,
    gather_kernel,
    gather_smem_kernel,
    three_nn_kernel,
    three_nn_q_kernel,
)

NAMESPACE = "pn2"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _op(schema: str, impl, fake) -> torch._ops.OpOverload:
    """Define NAMESPACE::<schema> with one impl for every device and its
    fake impl; return the op's default overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    # autograd passes through to the impl: the plain versions' arithmetic
    # records its own gradient on the CPU, the kernels none on the card
    _LIB.impl(name, torch.library.fallthrough_kernel, "Autograd")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _fps(xyz, npoint, skip_near_origin):
    if sampling.on_cuda(xyz):
        return fps_kernel.furthest_point_sample_cuda(
            xyz.contiguous(), npoint, skip_near_origin=skip_near_origin)
    return fps_kernel.furthest_point_sample_plain(xyz, npoint, skip_near_origin=skip_near_origin)


def _fps_fake(xyz, npoint, skip_near_origin):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


def _ball_query(radius, nsample, xyz, new_xyz):
    if neighborhood.on_cuda(xyz):
        return ball_query_kernel.ball_query_cuda(radius, nsample, xyz.contiguous(), new_xyz.contiguous())
    return ball_query_kernel.ball_query_plain(radius, nsample, xyz, new_xyz)


def _ball_query_fake(radius, nsample, xyz, new_xyz):
    return xyz.new_empty((*new_xyz.shape[:2], nsample), dtype=torch.int32)


def _ball_query_multi(radii, nsamples, xyz, new_xyz):
    if neighborhood.on_cuda(xyz):
        return ball_query_multi_kernel.ball_query_multi_cuda(
            radii, nsamples, xyz.contiguous(), new_xyz.contiguous())
    return ball_query_multi_kernel.ball_query_multi_plain(radii, nsamples, xyz, new_xyz)


def _ball_query_multi_fake(radii, nsamples, xyz, new_xyz):
    if len(radii) != 2 or len(nsamples) != 2:
        raise ValueError(f"two radii and two nsamples, got {radii} and {nsamples}")
    return tuple(xyz.new_empty((*new_xyz.shape[:2], k), dtype=torch.int32) for k in nsamples)


def _gather(src, idx):
    if sampling.on_cuda(src):
        return gather_kernel.gather_cuda(src.contiguous(), idx.to(torch.int32).contiguous())
    return gather_kernel.gather_plain(src, idx)


def _gather_smem(src, idx):
    if mxu_gather.on_cuda(src):
        return gather_smem_kernel.gather_smem_cuda(src.contiguous(), idx.to(torch.int32).contiguous())
    return gather_smem_kernel.gather_smem_plain(src, idx)


def _gather_fake(src, idx):
    return src.new_empty((src.shape[0], idx.shape[1], src.shape[2]))


def _three_nn(unknown, known):
    if interpolate.on_cuda(unknown):
        return three_nn_kernel.three_nn_cuda(unknown.contiguous(), known.contiguous())
    return three_nn_kernel.three_nn_plain(unknown, known)


def _three_nn_q(unknown, known):
    if interpolate.on_cuda(unknown):
        return three_nn_q_kernel.three_nn_q_cuda(unknown.contiguous(), known.contiguous())
    return three_nn_q_kernel.three_nn_q_plain(unknown, known)


def _three_nn_fake(unknown, known):
    shape = (*unknown.shape[:2], 3)
    return unknown.new_empty(shape, dtype=torch.float32), unknown.new_empty(shape, dtype=torch.int32)


furthest_point_sample = _op(
    "furthest_point_sample(Tensor xyz, int npoint, bool skip_near_origin) -> Tensor", _fps, _fps_fake)
ball_query = _op(
    "ball_query(float radius, int nsample, Tensor xyz, Tensor new_xyz) -> Tensor",
    _ball_query, _ball_query_fake)
ball_query_multi = _op(
    "ball_query_multi(float[] radii, int[] nsamples, Tensor xyz, Tensor new_xyz) -> (Tensor, Tensor)",
    _ball_query_multi, _ball_query_multi_fake)
gather = _op("gather(Tensor src, Tensor idx) -> Tensor", _gather, _gather_fake)
gather_smem = _op("gather_smem(Tensor src, Tensor idx) -> Tensor", _gather_smem, _gather_fake)
three_nn = _op("three_nn(Tensor unknown, Tensor known) -> (Tensor, Tensor)", _three_nn, _three_nn_fake)
three_nn_q = _op("three_nn_q(Tensor unknown, Tensor known) -> (Tensor, Tensor)", _three_nn_q, _three_nn_fake)
