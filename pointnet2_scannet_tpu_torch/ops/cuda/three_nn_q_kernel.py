"""Three nearest neighbours, one warp per query: the CUDA kernel
(csrc/three_nn_q.cu) and its plain PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
(three_nn_pallas, the query-major kernel, which the JAX package takes where
its known-major kernel is refused; ops/tuning.three_nn_route copies that
routing). Contract, as three_nn_kernel.py's: the three smallest d^2
ascending with int32 indices, ties to the lowest index, bit-equal to the
plain version and to three_nn.cu. Where three_nn.cu scans all m known points
in one thread per query, this kernel spreads a query's scan over the 32
lanes of a warp and merges their top-3 lists; see csrc/three_nn_q.cu.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import build
from pointnet2_scannet_tpu_torch.ops.cuda.three_nn_kernel import three_nn_plain

NAME = "three_nn_q"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/three_nn_q.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py:140"

launches = 0


def three_nn_q_plain(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) -> (dist2 (B, n, 3) ascending, idx (B, n, 3) int32)."""
    return three_nn_plain(unknown, known)


def three_nn_q_cuda(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) float32 on the card, m >= 3 -> (dist2, idx);
    launches three_nn_q.cu."""
    global launches
    build.require(unknown, "unknown", (torch.float32,), 3, 3)
    build.require(known, "known", (torch.float32,), 3, 3)
    B, n, _ = unknown.shape
    m = known.shape[1]
    if known.shape[0] != B or known.device != unknown.device:
        raise ValueError("unknown and known must share batch size and device")
    if m < 3:
        raise ValueError(f"three_nn needs at least 3 known points, got {m}")
    dist2 = torch.empty((B, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=unknown.device)
    if B * n == 0:
        return dist2, idx
    with torch.cuda.device(unknown.device):
        err = build.library().p2_three_nn_q(
            build.ptr(unknown), build.ptr(known), B, n, m, build.ptr(dist2),
            build.ptr(idx), build.stream_of(unknown),
        )
    build.check(err, NAME)
    launches += 1
    return dist2, idx
