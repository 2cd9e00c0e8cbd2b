"""Furthest-point sampling: the CUDA kernels (csrc/fps.cu) and their plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/fps_kernel.py
(furthest_point_sample_pallas). On the card the npoint-1 dependent steps,
each ending in an argmax over the row, bound the kernel by the latency of a
step, and only B blocks (or clusters) run. The kernels keep xyz in shared
memory and every thread's min-distances (and, where they fit, its points)
in registers for the whole loop, so device memory is read once and written
once. A row of up to 16384 float32 / 8192 float64 points runs one block
with one barrier a step; a larger row runs a thread-block cluster of 8 blocks,
each thread with 8 float32 / 4 float64 points in registers (16 / 8 from
shared memory past 65536 / 32768 points), one reduction a block and one
exchange a step: each block sends its candidate into every block of the
cluster with st.async and waits on its own transaction barrier (plan()
picks; see the note at the head of csrc/fps.cu).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "furthest_point_sample"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/fps.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/fps_kernel.py:77"
# points a block holds: 12 (float32) or 24 (float64) bytes each in 192 KiB
# of shared memory, 16 (float32) or 8 (float64) a thread of 1024
BLOCK_POINTS = {torch.float32: 16384, torch.float64: 8192}
# points a thread of the cluster kernel keeps in registers with their
# min-distances (32 registers in either dtype); twice that, read from
# shared memory, past MAX_CLUSTER * MAX_THREADS * REG_POINTS a row
REG_POINTS = {torch.float32: 8, torch.float64: 4}
MAX_CLUSTER = 8  # the portable cluster size
MAX_THREADS = 1024

launches = 0
# launches by variant: "block" (one block a row), "cluster" (a cluster a row)
variant_launches = {"block": 0, "cluster": 0}


class Plan(NamedTuple):
    variant: str  # "block" or "cluster"
    cluster: int  # blocks a batch row
    threads: int  # threads a block
    ppt: int  # points a thread: 1, 2, 4, 8 or 16 (cluster: REG_POINTS or twice that)


@functools.lru_cache(maxsize=None)
def plan(n: int, dtype: torch.dtype) -> Plan:
    """The kernel variant and launch shape for rows of n points of dtype
    (float32 or float64).

    Up to BLOCK_POINTS, one block: threads cover the row 32 at a time up to
    1024, and each holds the smallest power of two of points that covers
    the rest. Above, a cluster of MAX_CLUSTER blocks, each thread with
    REG_POINTS points in registers where the block's share allows (up to
    MAX_THREADS * REG_POINTS), else twice that from shared memory; the
    threads cover the share 32 at a time. On the H100 the exchange between
    blocks took about the same time a step at 3 to 8 blocks, so the most
    blocks, each with the least to update, ran fastest at every row size
    measured, 3-8 blocks at (8, 20000) and 4-8 at (8, 32768) (PERF.md)."""
    per_block = BLOCK_POINTS[dtype]
    limit = MAX_CLUSTER * per_block
    if not 0 < n <= limit:
        raise ValueError(f"furthest_point_sample_cuda takes 0 < N <= {limit} in {dtype}, got {n}")
    if n <= per_block:
        threads = min(MAX_THREADS, -(-n // 32) * 32)
        ppt = 1
        while threads * ppt < n:
            ppt *= 2
        return Plan("block", 1, threads, ppt)
    share = -(-n // MAX_CLUSTER)
    ppt = REG_POINTS[dtype] if share <= MAX_THREADS * REG_POINTS[dtype] else 2 * REG_POINTS[dtype]
    return Plan("cluster", MAX_CLUSTER, -(-share // (32 * ppt)) * 32, ppt)


@functools.lru_cache(maxsize=None)
def resident_clusters(n: int, dtype: torch.dtype, device: int) -> int:
    """How many clusters of plan(n, dtype) the card `device` holds at once
    (cudaOccupancyMaxActiveClusters); a ValueError where none fits, before
    any launch. Rows past that many run in later waves."""
    p = plan(n, dtype)
    count = ctypes.c_int(0)
    err = build.library().p2_fps_clusters(
        int(dtype == torch.float64), n, p.cluster, p.threads, p.ppt, device, ctypes.byref(count))
    build.check(err, NAME)
    if count.value < 1:
        raise ValueError(f"furthest_point_sample_cuda: no cluster of {p.cluster} blocks of {p.threads} "
                         f"threads ({n} points of {dtype} a row) fits on card {device}")
    return count.value


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
    if B == 0 or npoint == 0:
        return torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    p = plan(N, xyz.dtype)
    if p.variant == "cluster":
        resident_clusters(N, xyz.dtype, xyz.get_device())
    out = launch(xyz, npoint, p, skip_near_origin)
    launches += 1
    variant_launches[p.variant] += 1
    return out


def launch(xyz: torch.Tensor, npoint: int, p: Plan, skip_near_origin: bool = True) -> torch.Tensor:
    """fps.cu at launch shape p on (B, N, 3) float32 or float64 xyz on the
    card (B, npoint > 0); counts nothing (profile_scatter times every
    candidate_plans() shape through it)."""
    B, N, _ = xyz.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    err = build.library().p2_fps(
        xyz.data_ptr(), B, N, npoint, int(skip_near_origin), int(xyz.dtype == torch.float64),
        p.cluster, p.threads, p.ppt, out.data_ptr(), xyz.get_device(), build.stream_of(xyz))
    build.check(err, NAME)
    return out


def candidate_plans(n: int, dtype: torch.dtype) -> list[Plan]:
    """The cluster launches fps.cu takes for rows of n points past
    BLOCK_POINTS: REG_POINTS a thread in registers at every cluster size
    from the least that holds the row up to MAX_CLUSTER, then twice that a
    thread from shared memory at every size that holds the row."""
    out = []
    for ppt in (REG_POINTS[dtype], 2 * REG_POINTS[dtype]):
        for cluster in range(max(2, -(-n // (MAX_THREADS * ppt))), MAX_CLUSTER + 1):
            share = -(-n // cluster)
            out.append(Plan("cluster", cluster, -(-share // (32 * ppt)) * 32, ppt))
    return out
