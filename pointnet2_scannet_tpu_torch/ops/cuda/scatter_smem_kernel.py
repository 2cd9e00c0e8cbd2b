"""Deterministic scatter-add into shared memory (the backward of
gather_smem.cu): the CUDA kernel (csrc/scatter_smem.cu) and its plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_bwd, the VJP of mxu_gather). Contract, as scatter_kernel.py's:
out[b, n] = the sum of g[b, j] over every j with idx[b, j] == n, added in
ascending j from +0.0, the same bits on every launch; unreferenced rows are
0. Where scatter_add.cu sorts the indices into CSR form in device memory,
this kernel keeps the TPU kernel's accumulator on chip: one block per
(batch row, row group, channel slice) adds into shared memory; see the note
at the head of csrc/scatter_smem.cu.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.scatter_kernel import scatter_add_plain

NAME = "scatter_smem"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/scatter_smem.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:98"
SMEM_BYTES = 200 * 1024  # a block's accumulator, ceil(n / groups) * cs * 4 bytes
MAX_N = 65535  # row groups of one row at most

launches = 0


def plan(b: int, n: int, c: int, sms: int) -> tuple[int, int]:
    """(cs, groups): the channels a block accumulates (slices of even width,
    at most 32, one a lane) and the row groups a batch row's output splits
    into: as many as the accumulator needs to fit in SMEM_BYTES, and up to
    one block for each of the card's sms multiprocessors. More blocks do not
    pay: every block walks all of its batch row's J indices."""
    cs = -(-c // -(-c // 32))
    slices = -(-c // cs)
    max_rows = SMEM_BYTES // (4 * cs)
    groups = max(-(-n // max_rows), sms // (b * slices))
    return cs, min(groups, n)


def scatter_smem_plain(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int x (B, J, C) -> (B, n, C), summed in ascending j on the
    CPU."""
    return scatter_add_plain(idx, g, n)


def scatter_smem_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int32 x (B, J, C) float32 on the card -> (B, n, C) float32;
    launches scatter_smem.cu with plan()'s split. Indices must lie in
    [0, n)."""
    global launches
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(g, "g", (torch.float32,), 3)
    B, J, C = g.shape
    if tuple(idx.shape) != (B, J) or idx.device != g.device:
        raise ValueError("idx must be (B, J) on the device of g (B, J, C)")
    if not 0 < n <= MAX_N:
        raise ValueError(f"scatter_smem_cuda takes 0 < n <= {MAX_N}, got {n}")
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    cs, groups = plan(B, n, C, build.sm_count(g))
    with torch.cuda.device(g.device):
        err = build.library().p2_scatter_smem(
            build.ptr(idx), build.ptr(g), B, n, J, C, cs, groups,
            build.ptr(out), build.stream_of(g),
        )
    build.check(err, NAME)
    launches += 1
    return out
