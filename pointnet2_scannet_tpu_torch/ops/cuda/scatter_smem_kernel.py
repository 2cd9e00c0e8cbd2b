"""Deterministic scatter-add (the backward of gather_smem.cu): the CUDA
kernels (csrc/scatter_smem.cu) and their plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_bwd, the VJP of mxu_gather). Contract for float32 g, as
scatter_kernel.py's: out[b, n] = the sum of g[b, j] over every j with
idx[b, j] == n, added in ascending j from +0.0, the same bits on every
launch; unreferenced rows are 0. bfloat16 g is summed in the TPU kernel's
order, whose bfloat16 accumulator rounds once a 128-index tile: for each
tile of TILE_J consecutive j of a batch row (J a multiple of TILE_J), the
float32 sum of its terms in ascending j, rounded to bfloat16 (to nearest
even), then acc = bfloat16(float32(acc) + float32(that sum)), tiles in
ascending order from +0 (not scatter_kernel.py's single rounding, which
agrees with the TPU kernel at only about half the elements where rows
collect many terms). bfloat16 always takes the sort route. Each index row
is sorted once, in parallel over the card (a stable
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
TILE_J = 128  # the TPU kernel's index tile (gather_kernel.py:29): bfloat16 rounds once a tile
MIN_TILE, MAX_TILE = 1024, 8192  # indices a sort block takes
MAX_WALKERS = 8  # warps that rank a tile, each a stretch with its own cursors
PLACE_BYTES = 100 * 1024  # a ranking block's shared memory, two blocks an SM
SUM_THREADS = 256  # 8 sum warps a block
MAX_ROWS = 16  # output rows a sum warp takes
SHARED_BYTES = 227 * 1024  # a block's shared memory on an H100
ACCUMULATE_BYTES = 200 * 1024  # an accumulate block's rows, ceil(n / groups) * cs * 4 bytes
ACCUMULATE_WORK = 65536  # indices the accumulate route's blocks of a batch row walk, at most

launches = 0
bf16_launches = 0  # of those, the launches on bfloat16 cotangents


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
def plan(b: int, n: int, j: int, c: int, sms: int, esize: int = 4) -> Plan | AccumulatePlan:
    """For float32 (esize 4), the accumulate route's split where its blocks
    of a batch row walk at most ACCUMULATE_WORK indices in all, else the
    sort route's plan; for bfloat16 (esize 2) always the sort route's."""
    acc = accumulate_plan(b, n, c, sms)
    if esize == 4 and acc.groups * -(-c // acc.cs) * j <= ACCUMULATE_WORK:
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


def _check_tiles(j: int) -> None:
    if j % TILE_J:
        raise ValueError(f"scatter_smem takes bfloat16 cotangents only in whole {TILE_J}-index tiles "
                         f"(J % {TILE_J} == 0, as the MXU gather's gate admits), got J = {j}")


def scatter_smem_plain(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int x (B, J, C) -> (B, n, C) of g's dtype: float32 summed in
    ascending j (scatter_kernel.scatter_add_plain; on the CPU), bfloat16
    tile by tile (the module's contract). The bfloat16 branch sums each
    (batch row, tile, row) key's terms with scatter_add_ into a compact
    float32 table (ascending j on the CPU), rounds it, then folds the
    tiles into each output row in ascending tile order, one round per
    tile rank; its memory is O(B J C), not O(B J / TILE_J n C)."""
    if g.dtype != torch.bfloat16:
        return scatter_add_plain(idx, g, n)
    B, J, C = g.shape
    _check_tiles(J)
    tiles = J // TILE_J
    dev = g.device
    j = torch.arange(J, device=dev)
    batch = torch.arange(B, device=dev)[:, None]
    keys, inverse = torch.unique(((batch * tiles + j // TILE_J) * n + idx.long()).reshape(-1),
                                 return_inverse=True)  # ascending (b, tile, row)
    part = torch.zeros((len(keys), C), dtype=torch.float32, device=dev).scatter_add_(
        0, inverse[:, None].expand(-1, C), g.reshape(-1, C).float()).to(torch.bfloat16)
    dest = keys // (tiles * n) * n + keys % n  # flat output row b * n + row
    order = torch.sort(dest, stable=True).indices  # each row's tiles stay ascending
    dest, part = dest[order], part[order]
    first = torch.ones(len(dest), dtype=torch.bool, device=dev)
    first[1:] = dest[1:] != dest[:-1]
    starts = torch.nonzero(first).reshape(-1)
    rank = torch.arange(len(dest), device=dev) - starts[torch.cumsum(first.long(), 0) - 1]
    by_rank = torch.sort(rank, stable=True).indices
    out = torch.zeros((B * n, C), dtype=torch.bfloat16, device=dev)
    at = 0
    for count in torch.bincount(rank).tolist():  # the k-th tile of every row that has one
        sel = by_rank[at:at + count]
        rows = dest[sel]
        out[rows] = (out[rows].float() + part[sel].float()).to(torch.bfloat16)
        at += count
    return out.reshape(B, n, C)


def scatter_smem_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int32 x (B, J, C) float32/bfloat16 on the card -> (B, n, C)
    of g's dtype; launches scatter_smem.cu's accumulate route or its sort
    and sum, as plan() chooses (bfloat16: J a multiple of TILE_J).
    Indices must lie in [0, n)."""
    global launches, bf16_launches
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(g, "g", (torch.float32, torch.bfloat16), 3)
    B, J, C = g.shape
    if tuple(idx.shape) != (B, J) or idx.device != g.device:
        raise ValueError("idx must be (B, J) on the device of g (B, J, C)")
    if not 0 < n <= MAX_N:
        raise ValueError(f"scatter_smem_cuda takes 0 < n <= {MAX_N}, got {n}")
    bf16 = g.dtype == torch.bfloat16
    if bf16:
        _check_tiles(J)
    build.check_batch(B, NAME)
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    esize = g.element_size()
    p = plan(B, n, J, C, build.sm_count(g), esize)
    lib, device, stream = build.library(), g.get_device(), build.stream_of(g)
    if isinstance(p, AccumulatePlan):
        err = lib.p2_scatter_smem_accumulate(
            build.ptr(idx), build.ptr(g), B, n, J, C, p.cs, p.groups, build.ptr(out), device, stream)
    else:
        scratch = torch.empty(B * (p.tiles * n + n + 1 + J), dtype=torch.int32, device=g.device)
        err = lib.p2_scatter_smem(
            build.ptr(idx), build.ptr(g), B, n, J, C, p.tile, p.walkers, p.rows, esize,
            build.ptr(scratch), build.ptr(out), device, stream)
    build.check(err, NAME)
    launches += 1
    if bf16:
        bf16_launches += 1
    return out
