"""Three nearest neighbours: the CUDA kernel (csrc/three_nn.cu) and its plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
(three_nn_pallas_t). On the card the op is bound by its n x m distance
evaluations. The kernel gives each unknown point one thread with a running
top-3 in registers, streams the known points through shared memory, and
inserts with strict < in index order, which reproduces the lowest-index
tie-break of the TPU kernel's knock-out passes; see csrc/three_nn.cu.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "three_nn"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/three_nn.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py:94"

launches = 0


def three_nn_plain(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) -> (dist2 (B, n, 3) ascending, idx (B, n, 3) int32).

    Three rounds of min, first index attaining it, knock-out — the TPU
    kernel's passes, so ties go to the lowest index.
    """
    d = pairwise_sqdist(unknown, known)  # (B, n, m)
    m = d.shape[-1]
    iota = torch.arange(m, dtype=torch.int32, device=d.device)
    sentinel = torch.tensor(m, dtype=torch.int32, device=d.device)
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    dists, idxs = [], []
    for k in range(3):
        dmin = d.amin(dim=-1, keepdim=True)
        sel = torch.where(d == dmin, iota, sentinel).amin(dim=-1, keepdim=True)
        dists.append(dmin)
        idxs.append(sel)
        if k < 2:
            d = torch.where(iota == sel, inf, d)
    return torch.cat(dists, dim=-1), torch.cat(idxs, dim=-1)


def three_nn_cuda(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) float32 on the card, m >= 3 -> (dist2, idx);
    launches three_nn.cu."""
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
        err = build.library().p2_three_nn(
            build.ptr(unknown), build.ptr(known), B, n, m, build.ptr(dist2),
            build.ptr(idx), build.stream_of(unknown),
        )
    build.check(err, NAME)
    launches += 1
    return dist2, idx
