"""Row gather: the CUDA kernel (csrc/gather.cu) and its plain PyTorch
version.

Replaces pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py
(_vmem_gather_fwd_only, reached through vmem_gather and vmem_gather_any).
On the card the gather is bound by bytes once enough loads are in flight:
each block stages the source offsets of its tile's rows in shared memory,
then every thread issues its words' loads together before storing them,
16 bytes a word where the rows allow it (plan() picks; see the note at the
head of csrc/gather.cu). Its backward is the deterministic scatter-add of
scatter_kernel.py, wired in ops/sampling.gather_points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "gather"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/gather.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py:82"
THREADS = 256  # threads a block
MAX_PER_THREAD = 8  # words a thread moves
MAX_ROW_WORDS = 2**31 - 1  # words of one output batch row (J x C / vec)

launches = 0


class Plan(NamedTuple):
    vec: int  # 4-byte words a load moves: 4 where C % 4 == 0, else 1
    per_thread: int  # words a thread moves: 8, or fewer where blocks are few
    blocks: int  # blocks of the launch (one tile of per_thread x THREADS words each)


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, j: int, c: int, sms: int) -> Plan:
    """The launch for idx (b, j) into src (b, n, c) on a card of sms
    multiprocessors: 16-byte words where C % 4 == 0 (launch() takes 4-byte
    ones for a pointer off 16-byte alignment); 8 words a thread, fewer (4,
    2, 1) while that leaves under two blocks a multiprocessor."""
    vec = 4 if c % 4 == 0 else 1
    words = b * j * (c // vec)
    per_thread = MAX_PER_THREAD
    while per_thread > 1 and -(-words // (per_thread * THREADS)) < 2 * sms:
        per_thread //= 2
    return Plan(vec, per_thread, -(-words // (per_thread * THREADS)))


def gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int -> (B, J, C): out[b, j] = src[b, idx[b, j]]."""
    C = src.shape[-1]
    index = idx.to(torch.int64).unsqueeze(-1).expand(-1, -1, C)
    return torch.gather(src, 1, index)


def launch(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor, p: Plan) -> torch.Tensor:
    """gather.cu with plan p into out (B, J, C) on checked tensors; 4-byte
    words where src or out lies off 16-byte alignment."""
    global launches
    B, N, C = src.shape
    J = idx.shape[1]
    s, o = src.data_ptr(), out.data_ptr()
    vec = p.vec if (s | o) % 16 == 0 else 1
    if J * C // vec > MAX_ROW_WORDS:
        raise ValueError(f"gather_cuda takes at most {MAX_ROW_WORDS} words an output batch row")
    err = build.library().p2_gather(
        s, idx.data_ptr(), B, N, J, C, vec, p.per_thread, o, src.get_device(), build.stream_of(src))
    build.check(err, NAME)
    launches += 1
    return out


def gather_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32/int32 x (B, J) int32 on the card -> (B, J, C);
    launches gather.cu. Indices must lie in [0, N)."""
    build.require(src, "src", (torch.float32, torch.int32), 3)
    build.require(idx, "idx", (torch.int32,), 2)
    B, N, C = src.shape
    J = idx.shape[1]
    if idx.shape[0] != B or idx.get_device() != src.get_device():
        raise ValueError("src and idx must share batch size and device")
    out = torch.empty((B, J, C), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    if N == 0:
        raise ValueError("gather_cuda needs a non-empty source")
    return launch(src, idx, out, plan(B, N, J, C, build.sm_count(src)))
