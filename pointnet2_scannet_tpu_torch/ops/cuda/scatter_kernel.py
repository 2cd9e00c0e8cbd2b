"""Deterministic scatter-add (the row gather's backward): the CUDA kernels
(csrc/scatter_add.cu) and their plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_split_bwd, reached through mxu_scatter_add from the row
gather's VJP). Contract: out[b, n] = the sum of g[b, j] over every j with
idx[b, j] == n, added in float32 in ascending j from +0.0, the same bits on
every launch; unreferenced rows are 0. No float atomics. bfloat16 g is
widened to float32 element by element and each output rounded once to
bfloat16 (to nearest even), as the TPU kernel sums bfloat16 cotangents in
float32 and casts once; the bfloat16 routes read half the f32 bytes. plan() picks one of two
routes from the shapes alone: where a batch row's indices and their sort fit
one block's shared memory (every backward of the SSG and MSG train steps),
one launch of a kernel whose blocks each sort their row there and stream
its g rows through a page of shared memory in sorted order, summing each
output row in a register; elsewhere (J above 65535, as at P3's FP0), the
card-wide sort and ordered sum of csr_sort.cuh that scatter_smem.cu's sort
route runs too. See the note at the head of csrc/scatter_add.cu.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "scatter_add"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/scatter_add.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:227"
MAX_N = 65535  # the sort route's keys fit 16 bits
MAX_BLOCK_J = 65535  # the block route's counts and ranks fit 16 bits
BLOCK_WARPS = 32  # warps of a block-route block
MAX_PAGE = 1024  # g rows a stage of the block route's page holds
MAX_CHUNKS = 4  # 32-channel chunks of a block-route block's slice
BLOCK_BYTES = 226 * 1024  # a block-route block's dynamic shared memory (one a multiprocessor)

launches = 0
bf16_launches = 0  # of those, the launches on bfloat16 cotangents
route_launches = {"block": 0, "sort": 0}  # of those, the launches by route


class BlockPlan(NamedTuple):
    chunks: int  # 32-channel chunks of a block's slice of channels
    vec: int  # elements a copy into the page moves (copy_vec)
    rows: int  # consecutive output rows a block takes
    groups: int  # blocks a batch row's output splits into, per slice
    walkers: int  # warps that sort a block's row, a stretch of j each
    page: int  # g rows a stage of the page holds


def copy_vec(c: int, esize: int) -> int:
    """Elements of a g row a copy into the page moves: 16 bytes where C
    holds whole 16-byte runs, else 4 bytes where it holds whole 4-byte ones,
    else one element (2-byte bfloat16 rows of odd C)."""
    for nbytes in (16, 4):
        if (c * esize) % nbytes == 0 and nbytes >= esize:
            return nbytes // esize
    return 1


def block_bytes(p: BlockPlan, j: int, esize: int = 4) -> int:
    """Dynamic shared memory of a block-route block with esize-byte
    elements of g: offsets (rows + 1, rounded up to 16 bytes), then the
    walkers' 16-bit counters or the page's two stages, whichever is larger,
    then order (j 16-bit entries)."""
    stages = 2 * p.page * 32 * p.chunks * esize // 4
    return 4 * ((p.rows + 4) // 4 * 4 + max(p.walkers * ((p.rows + 1) // 2), stages)) + 2 * j


def block_plan(b: int, n: int, j: int, c: int, sms: int, esize: int = 4) -> BlockPlan | None:
    """The block route's split for idx (b, j) into (b, n, c) on a card of
    sms multiprocessors, or None where a row does not fit: slices of as few
    32-channel chunks (up to MAX_CHUNKS) as give each multiprocessor at most
    one block; 16-byte copies into the page where the rows allow them
    (copy_vec; launch() takes smaller ones for g rows off 16-byte
    alignment); output rows in
    groups, as many as give each multiprocessor a block where the batch
    rows and slices alone do not; a page as large as shared memory holds
    beside the offsets and the row's order (at most MAX_PAGE, no more than
    the row's entries; esize 2 halves an entry's bytes); as many sorting
    warps as their counters fit beside it. On the H100, blocks that walk fewer, longer pages measured faster
    than wider slices or more groups at J >= 2048, and wider slices faster
    at the deep levels' short rows (PERF.md)."""
    if j > MAX_BLOCK_J:
        return None
    nch = -(-c // 32)
    chunks = next((k for k in range(1, MAX_CHUNKS) if b * -(-nch // k) <= sms), MAX_CHUNKS)
    chunks = -(-nch // -(-nch // chunks))  # slices as even as they go
    slices = -(-nch // chunks)
    groups = min(n, max(1, sms // (b * slices)))
    rows = -(-n // groups)
    free = BLOCK_BYTES // 4 - (rows + 4) // 4 * 4 - -(-j // 2)
    page = min(MAX_PAGE, max(j, 1), free // (16 * esize * chunks))
    walkers = min(BLOCK_WARPS, max(1, -(-j // 32)), free // ((rows + 1) // 2))
    if page < 1 or walkers < 1:
        return None
    return BlockPlan(chunks, copy_vec(c, esize), rows, -(-n // rows), walkers, page)


def candidate_plans(b: int, n: int, j: int, c: int, sms: int, esize: int = 4) -> list:
    """Every route that can take the shape: the block route's plan where a
    row fits, and the card-wide sort's (scatter_smem_kernel.sort_plan)."""
    # imported here: scatter_smem_kernel imports this module's plain version
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel

    block = block_plan(b, n, j, c, sms, esize)
    return ([block] if block is not None else []) + [scatter_smem_kernel.sort_plan(b, n, j, c, sms)]


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, j: int, c: int, sms: int, esize: int = 4):
    """The block route where a row fits, else the card-wide sort."""
    return candidate_plans(b, n, j, c, sms, esize)[0]


def scatter_add_plain(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int x (B, J, C) -> (B, n, C) of g's dtype, summed in at
    least float32 and rounded once (bfloat16 g: the f32 sum cast to
    bfloat16, the kernel's contract and the JAX VJP's). On the CPU
    scatter_add_ adds in ascending j, like XLA's scatter and the kernel; on
    the card its atomics add in no fixed order."""
    B, J, C = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    index = idx.to(torch.int64).unsqueeze(-1).expand(B, J, C)
    out = torch.zeros((B, n, C), dtype=acc, device=g.device).scatter_add_(1, index, g.to(acc))
    return out.to(g.dtype)


def launch(idx: torch.Tensor, g: torch.Tensor, n: int, p) -> torch.Tensor:
    """scatter_add.cu's route for plan p (a BlockPlan, or a sort_plan()
    Plan) on checked tensors; at most one scratch tensor."""
    global launches, bf16_launches
    B, J, C = g.shape
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    esize = g.element_size()
    if isinstance(p, BlockPlan) and g.data_ptr() % (p.vec * esize):
        p = p._replace(vec=1)  # a copy needs g's rows aligned to its size
    lib, device, stream = build.library(), g.get_device(), build.stream_of(g)
    if isinstance(p, BlockPlan):
        err = lib.p2_scatter_add(
            idx.data_ptr(), g.data_ptr(), B, n, J, C, p.chunks, p.vec, p.rows, p.walkers, p.page,
            esize, out.data_ptr(), device, stream)
    else:
        scratch = torch.empty(B * (p.tiles * n + n + 1 + J), dtype=torch.int32, device=g.device)
        err = lib.p2_scatter_add_sort(
            idx.data_ptr(), g.data_ptr(), B, n, J, C, p.tile, p.walkers, p.rows, esize,
            scratch.data_ptr(), out.data_ptr(), device, stream)
    build.check(err, NAME)
    launches += 1
    route_launches["block" if isinstance(p, BlockPlan) else "sort"] += 1
    if g.dtype == torch.bfloat16:
        bf16_launches += 1
    return out


def _check(idx: torch.Tensor, g: torch.Tensor, n: int, what: str) -> None:
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(g, "g", (torch.float32, torch.bfloat16), 3)
    B, J, C = g.shape
    if tuple(idx.shape) != (B, J) or idx.device != g.device:
        raise ValueError("idx must be (B, J) on the device of g (B, J, C)")
    if not 0 < n <= MAX_N:
        raise ValueError(f"{what} takes 0 < n <= {MAX_N}, got {n}")
    build.check_batch(B, NAME)


def scatter_add_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """(B, J) int32 x (B, J, C) float32/bfloat16 on the card -> (B, n, C)
    of g's dtype; launches scatter_add.cu's route that plan() picks.
    Indices must lie in [0, n)."""
    _check(idx, g, n, "scatter_add_cuda")
    B, J, C = g.shape
    return launch(idx, g, n, plan(B, n, J, C, build.sm_count(g), g.element_size()))


def scatter_add_sorted_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """scatter_add_cuda on the card-wide sort route at every shape: each
    index row sorted once over the card, each output row summed in
    ascending j (the sort and segment sum of the grouping gathers'
    group_segsum backward, ops/neighborhood.group_points_segsum). The same
    contract and bits as scatter_add_cuda."""
    _check(idx, g, n, "scatter_add_sorted_cuda")
    # imported here: scatter_smem_kernel imports this module's plain version
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel

    B, J, C = g.shape
    return launch(idx, g, n, scatter_smem_kernel.sort_plan(B, n, J, C, build.sm_count(g)))
