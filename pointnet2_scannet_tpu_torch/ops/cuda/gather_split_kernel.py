"""The exact gather of mxu_gather_split: gather_smem.cu launched through a
wrapper of its own, and its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_split_fwd_only, the forward of mxu_gather_split). The TPU
kernel splits the float32 source into three bf16 planes so that a bf16
one-hot product on the MXU still returns every float32 word exactly (a
bfloat16 source is cast to float32 first and the result cast back: an
exact bfloat16 gather); its function and shapes are mxu_gather's, and the
card copies words exactly, so it runs gather_smem.cu (see
gather_smem_kernel.py). This module counts those launches apart from
mxu_gather's.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel
from pointnet2_scannet_tpu_torch.ops.cuda.gather_kernel import gather_plain

NAME = "gather_split"
SOURCE = gather_smem_kernel.SOURCE
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:205"

launches = 0
bf16_launches = 0  # of those, the launches on bfloat16 rows


def gather_split_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int -> (B, J, C): the row gather."""
    return gather_plain(src, idx)


def gather_split_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32/bfloat16 x (B, J) int32 on the card -> (B, J, C);
    launches gather_smem.cu. Indices must lie in [0, N)."""
    global launches, bf16_launches
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_split takes a float32 or bfloat16 source, got {src.dtype}")
    out = gather_smem_kernel.launch(src, idx)
    if out.numel():
        launches += 1
        if src.dtype == torch.bfloat16:
            bf16_launches += 1
    return out
