"""Furthest-point sampling: the CUDA kernels (csrc/fps.cu) and their plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/fps_kernel.py
(furthest_point_sample_pallas). On the card the npoint-1 dependent steps,
each ending in an argmax over the row, bound the kernel by the latency of a
step, and only B blocks (or clusters) run. The kernels keep xyz in shared
memory and every thread's min-distances (and, in float32 up to 8 a thread,
its points) in registers for the whole loop, so device memory is read once
and written once. A row that fits one block's shared memory runs one block
with one barrier a step; a larger row runs a thread-block cluster of up to
8 blocks that agree on each step's winner through distributed shared
memory (plan() picks; see the note at the head of csrc/fps.cu).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "furthest_point_sample"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/fps.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/fps_kernel.py:77"
# points a block holds: 12 (float32) or 24 (float64) bytes each in 192 KiB
# of shared memory, 16 (float32) or 8 (float64) registers a thread
BLOCK_POINTS = {torch.float32: 16384, torch.float64: 8192}
MAX_CLUSTER = 8  # the portable cluster size
MAX_THREADS = 1024

launches = 0
# launches by variant: "block" (one block a row), "cluster" (a cluster a row)
variant_launches = {"block": 0, "cluster": 0}


class Plan(NamedTuple):
    variant: str  # "block" or "cluster"
    cluster: int  # blocks a batch row
    threads: int  # threads a block
    ppt: int  # points a thread: 1, 2, 4, 8 or 16


@functools.lru_cache(maxsize=None)
def plan(n: int, dtype: torch.dtype) -> Plan:
    """The kernel variant and launch shape for rows of n points of dtype
    (float32 or float64): one block where the row fits BLOCK_POINTS, else a
    cluster of ceil(n / BLOCK_POINTS) blocks, at most MAX_CLUSTER; threads
    cover a block's share 32 at a time up to 1024, and each holds the
    smallest power of two of points that covers the rest. On the H100 a row
    that fits one block ran slower split over a cluster of 2, 4 or 8 blocks
    at every SSG level (PERF.md)."""
    per_block = BLOCK_POINTS[dtype]
    limit = MAX_CLUSTER * per_block
    if not 0 < n <= limit:
        raise ValueError(f"furthest_point_sample_cuda takes 0 < N <= {limit} in {dtype}, got {n}")
    cluster = -(-n // per_block)
    share = -(-n // cluster)
    threads = min(MAX_THREADS, -(-share // 32) * 32)
    ppt = 1
    while threads * ppt < share:
        ppt *= 2
    return Plan("block" if cluster == 1 else "cluster", cluster, threads, ppt)


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
    """(B, N, 3) float on the card -> (B, npoint) int32; launches fps.cu.
    float64 runs in float64; float16 and bfloat16 compute in float32, as the
    plain version does."""
    global launches
    build.require(xyz, "xyz", (torch.float32, torch.float64, torch.float16, torch.bfloat16), 3, 3)
    if xyz.dtype in (torch.float16, torch.bfloat16):
        xyz = xyz.float()
    B, N, _ = xyz.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    p = plan(N, xyz.dtype)
    err = build.library().p2_fps(
        xyz.data_ptr(), B, N, npoint, int(skip_near_origin), int(xyz.dtype == torch.float64),
        p.cluster, p.threads, p.ppt, out.data_ptr(), xyz.get_device(), build.stream_of(xyz))
    build.check(err, NAME)
    launches += 1
    variant_launches[p.variant] += 1
    return out
