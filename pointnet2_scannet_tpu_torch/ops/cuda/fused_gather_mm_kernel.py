"""Row gather fused with the layer-0 matrix product: the CUDA kernel
(csrc/fused_gather_mm.cu) and its plain PyTorch version.

Replaces scripts/bench_fused_sa.py:69 (fused_gather_mm), which gathers the
SA1 rows with 128-lane selects and applies the layer-0 weight on the TPU's
VPU, writing only the (B, J, F) pre-activations. On the card the function
is bound by bytes (the output is F / C times the gathered rows). plan()
picks the kernel's route: at bench_fused_sa's C 9 and F 32 the fixed route
(C and F compiled in, each thread's slice of w in registers, a persistent
grid over 128-row tiles), elsewhere the general one (w in shared memory). Both
add w[c, f] * g[c] for c ascending from 0, every operation rounded on its
own, as the plain version does, so they are equal bit for bit. The TPU
kernel defines no gradient, and neither does this one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.gather_kernel import gather_plain

NAME = "fused_gather_mm"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/fused_gather_mm.cu"
REPLACES = "scripts/bench_fused_sa.py:69"
SMEM_BYTES = 200 * 1024  # w on the general route, C * F * 4 bytes
THREADS = 256
COLS = 4  # consecutive output words a thread computes
FIXED = (9, 32)  # (C, F) of the fixed route: bench_fused_sa's layer 0
TILE_ROWS = 128  # rows of a fixed-route tile (32 rows a step, 4 steps)
RESIDENT = 3  # fixed-route blocks an SM holds at once (the kernel's launch bounds)
MAX_WORDS = 2**31 - 1  # N * C, J * F and the tiles on the fixed route (32-bit offsets)
ROUTES = {"general": 0, "fixed": 1}  # the C entry point's route argument

launches = 0


class Plan(NamedTuple):
    route: str  # a key of ROUTES
    blocks: int  # fixed: blocks of the persistent grid; general: blocks of the grid-stride loop


def _fixed(b: int, j: int, sms: int, per_sm: int) -> Plan:
    return Plan("fixed", min(per_sm * sms, b * -(-j // TILE_ROWS)))


def _general(b: int, j: int, f: int, sms: int) -> Plan:
    return Plan("general", min(-(-b * j * -(-f // COLS) // THREADS), 64 * sms))


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, j: int, c: int, f: int, sms: int) -> Plan:
    """The launch for src (b, n, c), idx (b, j) and w (c, f) on a card of sms
    multiprocessors: the fixed route at (c, f) == FIXED where its offsets fit
    32 bits, one wave of RESIDENT blocks an SM (fewer where there are fewer
    tiles); else the general route."""
    if (c, f) == FIXED and max(n * c, j * f, b * -(-j // TILE_ROWS)) <= MAX_WORDS:
        return _fixed(b, j, sms, RESIDENT)
    return _general(b, j, f, sms)


def candidate_plans(b: int, n: int, j: int, c: int, f: int, sms: int) -> list[Plan]:
    """Every launch the kernel takes at these shapes: the fixed route at 1,
    2 and RESIDENT blocks an SM (where plan() would take it), then the
    general route."""
    out = []
    if plan(b, n, j, c, f, sms).route == "fixed":
        out = [_fixed(b, j, sms, per_sm) for per_sm in range(1, RESIDENT + 1)]
    return out + [_general(b, j, f, sms)]


def fused_gather_mm_plain(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int x (C, F) -> (B, J, F): gather(src, idx) @ w,
    summed as out = out + g[c] * w[c] for c ascending from out = 0."""
    g = gather_plain(src, idx)
    out = torch.zeros(g.shape[:2] + w.shape[1:], dtype=torch.promote_types(src.dtype, w.dtype),
                      device=src.device)
    for c in range(w.shape[0]):
        out = out + g[..., c : c + 1] * w[c]
    return out


def launch(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, out: torch.Tensor, p: Plan) -> torch.Tensor:
    """fused_gather_mm.cu with plan p into out (B, J, F) on checked tensors;
    4-byte stores where out lies off 16-byte alignment."""
    global launches
    B, N, C = src.shape
    J, F = idx.shape[1], w.shape[1]
    err = build.library().p2_fused_gather_mm(
        src.data_ptr(), idx.data_ptr(), w.data_ptr(), B, N, J, C, F, ROUTES[p.route], p.blocks,
        out.data_ptr(), src.get_device(), build.stream_of(src))
    build.check(err, NAME)
    launches += 1
    return out


def fused_gather_mm_cuda(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32 x (B, J) int32 x (C, F) float32 on the card ->
    (B, J, F) float32; launches fused_gather_mm.cu. Indices must lie in
    [0, N)."""
    build.require(src, "src", (torch.float32,), 3)
    build.require(idx, "idx", (torch.int32,), 2)
    build.require(w, "w", (torch.float32,), 2)
    B, N, C = src.shape
    J = idx.shape[1]
    F = w.shape[1]
    if idx.shape[0] != B or w.shape[0] != C or not src.device == idx.device == w.device:
        raise ValueError(f"shapes {tuple(src.shape)}, {tuple(idx.shape)}, {tuple(w.shape)} "
                         "or devices do not match")
    if C * F * 4 > SMEM_BYTES:
        raise ValueError(f"fused_gather_mm takes C * F <= {SMEM_BYTES // 4}, got {C} * {F}")
    out = torch.empty((B, J, F), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    if N == 0 or C == 0:
        raise ValueError("fused_gather_mm_cuda needs a non-empty source")
    return launch(src, idx, w, out, plan(B, N, J, C, F, build.sm_count(src)))
