"""Row gather through shared-memory tiles: the CUDA kernel
(csrc/gather_smem.cu) and its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
(_mxu_gather_fwd_only, the forward of mxu_gather). The TPU kernel is an
exact one-hot matrix product (float32 or bfloat16 rows) over a batch row's
source held in VMEM; this kernel computes the same function as a copy. It is
output-tile-stationary: a block of a persistent grid takes tiles of
consecutive output rows in order, copies the source rows they name into a
double-buffered shared-memory tile with cp.async and writes the tile, one
contiguous stretch of the output, with 16-byte stores; the source stays in
L2 (see the note at the head of csrc/gather_smem.cu). It copies raw words
(float32 and int32 as 4-byte words; bfloat16 rows of even C as int32 lane
pairs, other bfloat16 rows as 2-byte words, loaded without cp.async), so
-0.0 and non-finite values come out as they went in, where the TPU's
product gives +0.0 and spreads NaN. Its backward is
scatter_smem_kernel.py, wired in ops/mxu_gather.py; gather_split_kernel.py
launches the same kernel for mxu_gather_split.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.gather_kernel import bf16_words, gather_plain

NAME = "gather_smem"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/gather_smem.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:80"
TILE_BYTES = 32 * 1024  # one of a block's two tile buffers, at most
BLOCKS_PER_SM = 3  # of the persistent grid: 256 threads and ~65 KiB each
SHARED_BYTES = 227 * 1024  # a block's shared memory on an H100

launches = 0
bf16_launches = 0  # of those, the launches on bfloat16 rows


class Plan(NamedTuple):
    rows: int  # output rows a tile takes (a multiple of 4), or 1 for chunks
    width: int  # words of each tile row: C, or TILE_BYTES of words for rows split into chunks
    tiles: int  # tiles over the whole output
    blocks: int  # persistent grid


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, j: int, c: int, sms: int, esize: int = 4) -> Plan:
    """The tiles and grid for (b, n, c) x (b, j) of esize-byte words (4, or
    2 for bfloat16 rows that do not pair) on a card of sms multiprocessors.
    A tile holds as many whole rows as fit TILE_BYTES (a multiple of
    16 / esize, so every tile starts 16-byte aligned), but no more than
    gives every multiprocessor two tiles; a row too wide for that many a
    tile is split into chunks of TILE_BYTES, one a tile. The grid is
    BLOCKS_PER_SM blocks a multiprocessor, or one a tile where there are
    fewer."""
    total, step = b * j, 16 // esize
    if step * esize * c <= TILE_BYTES:
        fit = TILE_BYTES // (esize * c) // step * step
        even = -(-total // (2 * sms))
        rows = max(step, min(fit, -(-even // step) * step))
        width, tiles = c, -(-total // rows)
    else:
        rows, width = 1, TILE_BYTES // esize
        tiles = total * -(-c // width)
    return Plan(rows, width, tiles, min(tiles, BLOCKS_PER_SM * sms))


def shared_bytes(p: Plan, esize: int = 4) -> int:
    """A block's dynamic shared memory: two tiles (padded to 16 bytes) and
    two tiles' indices."""
    step = 16 // esize
    return 2 * esize * (-(-p.rows * p.width // step) * step) + 8 * p.rows


def gather_smem_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int -> (B, J, C): the row gather."""
    return gather_plain(src, idx)


def launch(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Run gather_smem.cu on (B, N, C) float32/int32/bfloat16 and (B, J)
    int32 on the card, with plan()'s tiles and grid; bfloat16 rows as
    gather_kernel.bf16_words gives their words. Counts no launch:
    gather_smem_cuda and gather_split_kernel.gather_split_cuda do."""
    build.require(src, "src", (torch.float32, torch.int32, torch.bfloat16), 3)
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
    words, words_out = bf16_words(src, out) if src.dtype == torch.bfloat16 else (src, out)
    c, esize = words.shape[-1], words.element_size()
    p = plan(B, N, J, c, build.sm_count(src), esize)
    err = build.library().p2_gather_smem(
        build.ptr(words), build.ptr(idx), B, N, J, c, p.rows, p.width, p.blocks, esize,
        build.ptr(words_out), src.get_device(), build.stream_of(src),
    )
    build.check(err, NAME)
    return out


def gather_smem_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32/int32/bfloat16 x (B, J) int32 on the card ->
    (B, J, C); launches gather_smem.cu. Indices must lie in [0, N)."""
    global launches, bf16_launches
    out = launch(src, idx)
    if out.numel():
        launches += 1
        if src.dtype == torch.bfloat16:
            bf16_launches += 1
    return out
