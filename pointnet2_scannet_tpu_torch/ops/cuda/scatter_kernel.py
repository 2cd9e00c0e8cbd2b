"""Deterministic scatter-add (the row gather's backward): the CUDA kernel
(csrc/scatter_add.cu) and its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_split_bwd, reached through mxu_scatter_add from the row
gather's VJP). Contract: out[b, n] = the sum of g[b, j] over every j with
idx[b, j] == n, added in ascending j from +0.0, the same bits on every
launch; unreferenced rows are 0. The kernel sorts each batch row's indices
into CSR form (a stable counting sort) and then sums each segment in order,
one warp per 32 channels, with no float atomics; see the note at the head of
csrc/scatter_add.cu.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "scatter_add"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/scatter_add.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:227"
MAX_N = 32768  # 4 N bytes of shared-memory counters per batch row

launches = 0


def scatter_add_plain(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int x (B, J, C) -> (B, n, C). On the CPU scatter_add_ adds in
    ascending j, like XLA's scatter and the kernel; on the card its atomics
    add in no fixed order."""
    B, J, C = g.shape
    index = idx.to(torch.int64).unsqueeze(-1).expand(B, J, C)
    return torch.zeros((B, n, C), dtype=g.dtype, device=g.device).scatter_add_(1, index, g)


def scatter_add_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int32 x (B, J, C) float32 on the card -> (B, n, C) float32;
    launches scatter_add.cu. Indices must lie in [0, n)."""
    global launches
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(g, "g", (torch.float32,), 3)
    B, J, C = g.shape
    if tuple(idx.shape) != (B, J) or idx.device != g.device:
        raise ValueError("idx must be (B, J) on the device of g (B, J, C)")
    if not 0 < n <= MAX_N:
        raise ValueError(f"scatter_add_cuda takes 0 < n <= {MAX_N}, got {n}")
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    offsets = torch.empty((B, n + 1), dtype=torch.int32, device=g.device)
    order = torch.empty((B, J), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = build.library().p2_scatter_add(
            build.ptr(idx), build.ptr(g), B, n, J, C, build.ptr(offsets),
            build.ptr(order), build.ptr(out), build.stream_of(g),
        )
    build.check(err, NAME)
    launches += 1
    return out
