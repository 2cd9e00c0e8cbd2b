"""Row gather out of shared memory: the CUDA kernel (csrc/gather_smem.cu) and
its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_fwd_only, the forward of mxu_gather). The TPU kernel is an
exact float32 one-hot matrix product over a batch row's source held in VMEM;
this kernel computes the same function as a copy, a group of the source's
rows staged whole in shared memory per block, each output row written by
the block whose group holds its source row (see the note at the head of
csrc/gather_smem.cu). It copies 32-bit words, so -0.0 and non-finite
values come out as they went in, where the TPU's product gives +0.0 and
spreads NaN. Its backward is
scatter_smem_kernel.py, wired in ops/mxu_gather.py; gather_split_kernel.py
launches the same kernel for mxu_gather_split.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.gather_kernel import gather_plain

NAME = "gather_smem"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/gather_smem.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:80"
SMEM_BYTES = 200 * 1024  # a block's staged rows, ceil(N / groups) * C * 4 bytes

launches = 0


def plan(b: int, n: int, c: int, sms: int) -> int:
    """groups: the row groups a batch row's source splits into, as many as
    its rows need to fit in SMEM_BYTES and up to one block for each of the
    card's sms multiprocessors."""
    max_rows = SMEM_BYTES // (4 * c)
    if max_rows < 1:
        raise ValueError(f"gather_smem takes C <= {SMEM_BYTES // 4}, got {c}")
    return min(max(-(-n // max_rows), sms // b), n)


def gather_smem_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int -> (B, J, C): the row gather."""
    return gather_plain(src, idx)


def launch(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Run gather_smem.cu on (B, N, C) float32/int32 and (B, J) int32 on the
    card, with plan()'s row groups. Counts no launch: gather_smem_cuda and
    gather_split_kernel.gather_split_cuda do."""
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
        raise ValueError("gather_smem needs a non-empty source")
    with torch.cuda.device(src.device):
        err = build.library().p2_gather_smem(
            build.ptr(src), build.ptr(idx), B, N, J, C, plan(B, N, C, build.sm_count(src)),
            build.ptr(out), build.stream_of(src),
        )
    build.check(err, NAME)
    return out


def gather_smem_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32/int32 x (B, J) int32 on the card -> (B, J, C);
    launches gather_smem.cu. Indices must lie in [0, N)."""
    global launches
    out = launch(src, idx)
    if out.numel():
        launches += 1
    return out
