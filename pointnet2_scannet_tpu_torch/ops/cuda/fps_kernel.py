"""Furthest-point sampling: the CUDA kernel (csrc/fps.cu) and its plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/fps_kernel.py
(furthest_point_sample_pallas). On the card the npoint-1 dependent steps,
each ending in a block-wide argmax, bound the kernel by synchronisation, and
only B blocks run. The kernel keeps xyz in shared memory and every thread's
min-distances in registers for the whole loop, so device memory is read once
and written once; see the note at the head of csrc/fps.cu.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "furthest_point_sample"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/fps.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/fps_kernel.py:77"
MAX_POINTS = 16384  # 12 N bytes of shared memory, 16 registers a thread

launches = 0


def furthest_point_sample_plain(
    xyz: torch.Tensor, npoint: int, *, skip_near_origin: bool = True
) -> torch.Tensor:
    """(B, N, 3) float -> (B, npoint) int32, one PyTorch step per pick.

    float32 and float64 keep their dtype; anything narrower computes in
    float32. The argmax takes the first maximum, so a tie goes to the lowest
    index; points with |p|^2 <= 1e-3 sit at -1 and are never picked.
    """
    B, N, _ = xyz.shape
    dt = xyz.dtype if xyz.dtype == torch.float64 else torch.float32
    xyz = xyz.to(dt)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if skip_near_origin:
        valid = (x * x + y * y) + z * z > 1e-3
    else:
        valid = torch.ones((B, N), dtype=torch.bool, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=dt, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    neg = torch.tensor(-1.0, dtype=dt, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, last]  # (B, 3)
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(torch.where(valid, mind, neg), dim=1)
        out[:, j] = last.to(torch.int32)
    return out


def furthest_point_sample_cuda(
    xyz: torch.Tensor, npoint: int, *, skip_near_origin: bool = True
) -> torch.Tensor:
    """(B, N, 3) float32 on the card -> (B, npoint) int32; launches fps.cu."""
    global launches
    build.require(xyz, "xyz", (torch.float32,), 3, 3)
    B, N, _ = xyz.shape
    if N > MAX_POINTS:
        raise ValueError(f"furthest_point_sample_cuda takes N <= {MAX_POINTS}, got {N}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    with torch.cuda.device(xyz.device):
        err = build.library().p2_fps(
            build.ptr(xyz), B, N, npoint, int(skip_near_origin),
            build.ptr(out), build.stream_of(xyz),
        )
    build.check(err, NAME)
    launches += 1
    return out
