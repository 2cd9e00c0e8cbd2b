"""Row gather: the CUDA kernel (csrc/gather.cu) and its plain PyTorch
version.

Replaces pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py
(_vmem_gather_fwd_only, reached through vmem_gather and vmem_gather_any).
On the card the gather is bound by bytes; the rows on the serving path are 3
to 259 words wide and unaligned, so the kernel reads one 32-bit word at a
time but writes 4 consecutive output words per thread with one 16-byte
store. Its backward is the deterministic scatter-add of scatter_kernel.py,
wired in ops/sampling.gather_points.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "gather"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/gather.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py:82"

launches = 0


def gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int -> (B, J, C): out[b, j] = src[b, idx[b, j]]."""
    C = src.shape[-1]
    index = idx.to(torch.int64).unsqueeze(-1).expand(-1, -1, C)
    return torch.gather(src, 1, index)


def gather_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32/int32 x (B, J) int32 on the card -> (B, J, C);
    launches gather.cu. Indices must lie in [0, N)."""
    global launches
    build.require(src, "src", (torch.float32, torch.int32), 3)
    build.require(idx, "idx", (torch.int32,), 2)
    B, N, C = src.shape
    J = idx.shape[1]
    if idx.shape[0] != B or idx.device != src.device:
        raise ValueError("src and idx must share batch size and device")
    out = torch.empty((B, J, C), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    if N == 0:
        raise ValueError("gather_cuda needs a non-empty source")
    with torch.cuda.device(src.device):
        err = build.library().p2_gather(
            build.ptr(src), build.ptr(idx), B, N, J, C, build.ptr(out),
            build.stream_of(src),
        )
    build.check(err, NAME)
    launches += 1
    return out
