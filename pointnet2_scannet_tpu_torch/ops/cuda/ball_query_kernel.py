"""Single-radius ball query: the CUDA kernel (csrc/ball_query.cu) and its
plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py
(ball_query_pallas). On the card the op is bound by instruction issue: a
query's scan reads most of its row before its nsample-th hit at SSG's SA1.
Each block stages its batch row in shared memory (whole, or two tiles at a
time past RESIDENT_POINTS), and a warp scans one query at a time, 128
points a step, appending hits in index order with ballots and popcounts
and stopping once the row is full; plan() picks the route and the grid.
The scan is csrc/ball_scan.cuh's, which the two-radius query shares; see
the notes at the head of csrc/ball_query.cu and csrc/ball_scan.cuh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "ball_query"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/ball_query.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py:80"

STEP = 128  # points a warp tests a step; a staged row or tile is a multiple
RESIDENT_POINTS = 16384  # rows up to this many points stay whole in shared memory (192 KiB)
TILE = 4096  # points a buffer of the tiled route holds (two of 48 KiB)
WARPS = 32  # warps a block
WAVES = 2  # blocks a batch row: enough to fill the multiprocessors this many times
MAX_TILED_QUERIES = 256  # queries a block of the tiled route holds counts for
SM_SHARED = 233472  # shared memory of a multiprocessor, bytes (H100: 228 KiB)
BLOCK_RESERVED = 1024  # of it, what the card reserves for each resident block
SM_THREADS = 2048  # threads a multiprocessor holds

launches = 0


class Plan(NamedTuple):
    route: str  # "resident" (the row whole in shared memory) or "tiled"
    tile: int  # points a shared-memory buffer holds: the row rounded up to STEP, or TILE
    warps: int  # warps a block
    per_block: int  # queries a block
    blocks: int  # blocks a batch row


def shared_bytes(p: Plan, radii: int = 1) -> int:
    """Shared memory a block of plan p takes for `radii` rows a query (1 here,
    2 for ball_query_multi.cu), static arrays included."""
    if p.route == "resident":
        return 12 * p.tile + 4
    return 2 * 12 * p.tile + 8 * radii * MAX_TILED_QUERIES


def route_plan(b: int, n: int, m: int, sms: int, route: str, warps: int, waves: float = WAVES,
               radii: int = 1) -> Plan:
    """The launch on a given route with warps a block, as many blocks a
    batch row as fill the multiprocessors `waves` times (by threads and
    shared memory), at least one query a warp."""
    tile = -(-n // STEP) * STEP if route == "resident" else TILE
    p = Plan(route, tile, warps, 0, 0)
    per_sm = min(SM_THREADS // (32 * warps), SM_SHARED // (shared_bytes(p, radii) + BLOCK_RESERVED))
    blocks = max(1, min(int(per_sm * sms * waves) // b, -(-m // warps)))
    per_block = -(-m // blocks)
    if route == "tiled":
        per_block = min(per_block, MAX_TILED_QUERIES)
    return p._replace(per_block=per_block, blocks=-(-m // per_block))


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, m: int, sms: int) -> Plan:
    """The launch for (b, n) points and (b, m) queries on a card of sms
    multiprocessors: the resident route up to RESIDENT_POINTS points a row,
    the tiled one above; WARPS warps a block; as many blocks a batch row as
    fill the multiprocessors WAVES times (by threads and shared memory), at
    least one query a warp. On the H100 at SSG's SA1 the second wave evened
    out the blocks' unequal scans (PERF.md)."""
    return route_plan(b, n, m, sms, "resident" if n <= RESIDENT_POINTS else "tiled", WARPS)


def candidate_plans(b: int, n: int, m: int, sms: int, radii: int = 1) -> list:
    """Launch shapes to profile: plan()'s route (and the tiled one where the
    row would stay whole) with 8, 16 and 32 warps a block, at blocks that
    fill the card once, twice and four times."""
    routes = ["tiled"] if n > RESIDENT_POINTS else ["resident", "tiled"]
    return [route_plan(b, n, m, sms, r, w, v, radii) for r in routes for w in (8, 16, 32)
            for v in (1, 2, 4)]


def ball_query_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, M, nsample) int32; see first_hits."""
    return first_hits(pairwise_sqdist(new_xyz, xyz), radius, nsample)


def first_hits(d2: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """(B, M, N) squared distances -> (B, M, nsample) int32.

    The first `nsample` indices with d^2 < r^2 in ascending order, the row
    padded with its first hit, all zeros for an empty ball. r^2 is taken in
    the distance dtype: f32(r) * f32(r) for float32, as the TPU kernel does.
    """
    N = d2.shape[-1]
    np_dt = np.float64 if d2.dtype == torch.float64 else np.float32
    r = np_dt(radius)
    valid = d2 < torch.tensor(r * r, dtype=d2.dtype, device=d2.device)
    iota = torch.arange(N, dtype=torch.int32, device=d2.device)
    sentinel = torch.tensor(N, dtype=torch.int32, device=d2.device)
    masked = torch.where(valid, iota, sentinel)
    k = min(nsample, N)
    # the values are the candidate indices themselves, so the k smallest in
    # ascending order are the first k hits whatever order topk gives to ties
    idx = torch.topk(masked, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        pad = sentinel.expand(*idx.shape[:-1], nsample - k)
        idx = torch.cat([idx, pad], dim=-1)
    first = idx[..., :1]
    fill = torch.where(first < N, first, torch.zeros_like(first))
    return torch.where(idx < N, idx, fill)


def launch(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, out: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """ball_query.cu with plan p into out (B, M, nsample) on checked
    tensors."""
    global launches
    B, N, _ = xyz.shape
    err = build.library().p2_ball_query(
        xyz.data_ptr(), new_xyz.data_ptr(), B, N, new_xyz.shape[1], float(radius), nsample,
        int(p.route == "tiled"), p.tile, p.warps, p.per_block, out.data_ptr(), xyz.get_device(),
        build.stream_of(xyz))
    build.check(err, NAME)
    launches += 1
    return out


def ball_query_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) float32 on the card -> (B, M, nsample) int32;
    launches ball_query.cu."""
    build.require(xyz, "xyz", (torch.float32,), 3, 3)
    build.require(new_xyz, "new_xyz", (torch.float32,), 3, 3)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.get_device() != xyz.get_device():
        raise ValueError("xyz and new_xyz must share batch size and device")
    build.check_batch(B, NAME)
    out = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    if B * M == 0 or nsample == 0:
        return out
    if N == 0:
        raise ValueError("ball_query_cuda needs at least one point")
    return launch(radius, nsample, xyz, new_xyz, out, plan(B, N, M, build.sm_count(xyz)))
