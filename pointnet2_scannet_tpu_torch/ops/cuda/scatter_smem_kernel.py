"""Deterministic scatter-add (the backward of gather_smem.cu): the CUDA
kernels (csrc/scatter_smem.cu) and their plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_bwd, the VJP of mxu_gather). Contract, as scatter_kernel.py's:
out[b, n] = the sum of g[b, j] over every j with idx[b, j] == n, added in
ascending j from +0.0, the same bits on every launch; unreferenced rows are
0. Each index row is sorted once, in parallel over the card (a stable
counting sort split into tiles of indices), and each output row is then
summed in registers by the warp that owns it and written once. Where a
batch row's index work is small (the accumulate route's blocks times J at
most ACCUMULATE_WORK, as at the MXU-gather configuration's shapes), the
on-chip accumulator runs instead: each block walks all J indices
and adds into shared memory, which costs less there than the sort's five
launches and scattered row loads. See the note at the head of
csrc/scatter_smem.cu.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.scatter_kernel import scatter_add_plain

NAME = "scatter_smem"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/scatter_smem.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:98"
MAX_N = 65535  # keys share a 32-bit word with their 16-bit rank in a tile
MIN_TILE, MAX_TILE = 1024, 8192  # indices a sort block takes
MAX_WALKERS = 8  # warps that rank a tile, each a stretch with its own cursors
PLACE_BYTES = 100 * 1024  # a ranking block's shared memory, two blocks an SM
SUM_THREADS = 256  # 8 sum warps a block
MAX_ROWS = 16  # output rows a sum warp takes
SHARED_BYTES = 227 * 1024  # a block's shared memory on an H100
ACCUMULATE_BYTES = 200 * 1024  # an accumulate block's rows, ceil(n / groups) * cs * 4 bytes
ACCUMULATE_WORK = 65536  # indices the accumulate route's blocks of a batch row walk, at most

launches = 0


class AccumulatePlan(NamedTuple):
    cs: int  # channels a block accumulates
    groups: int  # row groups a batch row's output splits into


class Plan(NamedTuple):
    tile: int  # indices a sort block takes
    tiles: int  # sort blocks a batch row
    walkers: int  # warps that rank a tile, a stretch each
    rows: int  # consecutive output rows a sum warp takes
    sum_blocks: int  # blocks of SUM_THREADS of the sum kernel


def accumulate_plan(b: int, n: int, c: int, sms: int) -> AccumulatePlan:
    """The accumulate route's split: channel slices of even width, at most
    32, one a lane, and as many row groups as the accumulator needs to fit
    ACCUMULATE_BYTES, up to one block for each of the card's sms
    multiprocessors."""
    cs = -(-c // -(-c // 32))
    slices = -(-c // cs)
    max_rows = ACCUMULATE_BYTES // (4 * cs)
    groups = max(-(-n // max_rows), sms // (b * slices))
    return AccumulatePlan(cs, min(groups, n))


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, j: int, c: int, sms: int) -> Plan | AccumulatePlan:
    """The accumulate route's split where its blocks of a batch row walk at
    most ACCUMULATE_WORK indices in all, else the sort route's plan."""
    acc = accumulate_plan(b, n, c, sms)
    if acc.groups * -(-c // acc.cs) * j <= ACCUMULATE_WORK:
        return acc
    return sort_plan(b, n, j, c, sms)


def sort_plan(b: int, n: int, j: int, c: int, sms: int) -> Plan:
    """The sort tiles and the sum grid for idx (b, j) into (b, n, c) on a
    card of sms multiprocessors. A tile is a power of two of at least n / 2
    indices (so the per-tile key counts, tiles x n words a row, stay within
    twice the index row), halved while the tiles of all rows would not give
    every multiprocessor one, within [MIN_TILE, MAX_TILE]. As many warps
    rank a tile as their cursors (n 16-bit counters each) fit PLACE_BYTES
    beside the tile, at least one. A sum warp takes one 32-channel chunk
    of rows rows: about 8 entries on average where three or more chunk
    warps read each run (C > 64), else about 64 (the rule that measured
    fastest on the H100 at P1's and bench_gather's shapes)."""
    tile = MIN_TILE
    while tile < min(MAX_TILE, n / 2):
        tile *= 2
    while tile > MIN_TILE and b * -(-j // tile) < sms:
        tile //= 2
    walkers = MAX_WALKERS
    while walkers > 1 and 4 * (tile + walkers * ((n + 1) // 2)) > PLACE_BYTES:
        walkers //= 2
    entries = 8 if c > 64 else 64
    rows = max(1, min(MAX_ROWS, entries * n // max(j, 1)))
    warps = b * -(-n // rows) * -(-c // 32)
    return Plan(tile, -(-j // tile), walkers, rows, -(-warps * 32 // SUM_THREADS))


def shared_bytes(p: Plan, n: int) -> int:
    """Dynamic shared memory of the ranking block, the largest: the tile's
    entries and each walker's n 16-bit cursors."""
    return 4 * (p.tile + p.walkers * ((n + 1) // 2))


def scatter_smem_plain(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int x (B, J, C) -> (B, n, C), summed in ascending j on the
    CPU."""
    return scatter_add_plain(idx, g, n)


def scatter_smem_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int32 x (B, J, C) float32 on the card -> (B, n, C) float32;
    launches scatter_smem.cu's accumulate route or its sort and sum, as
    plan() chooses.
    Indices must lie in [0, n)."""
    global launches
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(g, "g", (torch.float32,), 3)
    B, J, C = g.shape
    if tuple(idx.shape) != (B, J) or idx.device != g.device:
        raise ValueError("idx must be (B, J) on the device of g (B, J, C)")
    if not 0 < n <= MAX_N:
        raise ValueError(f"scatter_smem_cuda takes 0 < n <= {MAX_N}, got {n}")
    build.check_batch(B, NAME)
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    p = plan(B, n, J, C, build.sm_count(g))
    with torch.cuda.device(g.device):
        if isinstance(p, AccumulatePlan):
            err = build.library().p2_scatter_smem_accumulate(
                build.ptr(idx), build.ptr(g), B, n, J, C, p.cs, p.groups,
                build.ptr(out), build.stream_of(g),
            )
        else:
            scratch = torch.empty(B * (p.tiles * n + n + 1 + J), dtype=torch.int32, device=g.device)
            err = build.library().p2_scatter_smem(
                build.ptr(idx), build.ptr(g), B, n, J, C, p.tile, p.walkers, p.rows,
                build.ptr(scratch), build.ptr(out), build.stream_of(g),
            )
    build.check(err, NAME)
    launches += 1
    return out
