"""Three nearest neighbours where the JAX package takes its query-major
kernel: three_nn.cu launched through a wrapper of its own, and its plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
(three_nn_pallas, the query-major kernel, which the JAX package takes where
its known-major kernel is refused; ops/tuning.three_nn_route copies that
routing). Its contract is the known-major kernel's: the three smallest d^2
ascending with int32 indices, ties to the lowest index. The TPU needed two
kernels for the two tilings of its distance tile; on the card one thread
per query scanning the known points from shared memory serves both, so
this op runs three_nn.cu with three_nn_kernel.plan() (see
three_nn_kernel.py) and counts those launches apart from three_nn's.
"""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel
from pointnet2_scannet_tpu_torch.ops.cuda.three_nn_kernel import three_nn_plain

NAME = "three_nn_q"
SOURCE = three_nn_kernel.SOURCE
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
    launches three_nn.cu."""
    global launches
    out = three_nn_kernel.run(unknown, known, NAME)
    if out[0].numel():
        launches += 1
    return out
