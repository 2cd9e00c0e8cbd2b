"""Row gather fused with the layer-0 matrix product: the CUDA kernel
(csrc/fused_gather_mm.cu) and its plain PyTorch version.

Replaces scripts/bench_fused_sa.py:69 (fused_gather_mm), which gathers the
SA1 rows with 128-lane selects and applies the layer-0 weight on the TPU's
VPU, writing only the (B, J, F) pre-activations. On the card the function
is bound by bytes (the output is F / C times the gathered rows); the kernel
keeps w in shared memory, reads each index and source word once and writes
each output word once. Both versions add w[c, f] * g[c] for c ascending
from 0, every operation rounded on its own, so they are equal bit for bit.
The TPU kernel defines no gradient, and neither does this one.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.gather_kernel import gather_plain

NAME = "fused_gather_mm"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/fused_gather_mm.cu"
REPLACES = "scripts/bench_fused_sa.py:69"
SMEM_BYTES = 200 * 1024  # w, C * F * 4 bytes

launches = 0


def fused_gather_mm_plain(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int x (C, F) -> (B, J, F): gather(src, idx) @ w,
    summed as out = out + g[c] * w[c] for c ascending from out = 0."""
    g = gather_plain(src, idx)
    out = torch.zeros(g.shape[:2] + w.shape[1:], dtype=torch.promote_types(src.dtype, w.dtype),
                      device=src.device)
    for c in range(w.shape[0]):
        out = out + g[..., c : c + 1] * w[c]
    return out


def fused_gather_mm_cuda(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32 x (B, J) int32 x (C, F) float32 on the card ->
    (B, J, F) float32; launches fused_gather_mm.cu. Indices must lie in
    [0, N)."""
    global launches
    build.require(src, "src", (torch.float32,), 3)
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(w, "w", (torch.float32,), 2)
    B, N, C = src.shape
    J = idx.shape[1]
    F = w.shape[1]
    if idx.shape[0] != B or w.shape[0] != C or not src.device == idx.device == w.device:
        raise ValueError(f"shapes {tuple(src.shape)}, {tuple(idx.shape)}, {tuple(w.shape)} "
                         "or devices do not match")
    if C * F * 4 > SMEM_BYTES:
        raise ValueError(f"fused_gather_mm takes C * F <= {SMEM_BYTES // 4}, got {C} * {F}")
    out = torch.empty((B, J, F), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    if N == 0 or C == 0:
        raise ValueError("fused_gather_mm_cuda needs a non-empty source")
    with torch.cuda.device(src.device):
        err = build.library().p2_fused_gather_mm(
            build.ptr(src), build.ptr(idx), build.ptr(w), B, N, J, C, F, build.ptr(out),
            build.stream_of(src),
        )
    build.check(err, NAME)
    launches += 1
    return out
