"""Shared geometry helper for the point ops."""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) squared distances.

    The exact difference form ((dx*dx + dy*dy) + dz*dz), each operation
    rounded on its own: bit-comparable with the JAX package's
    pairwise_sqdist(mode="exact") and with the CUDA kernels (csrc/sqdist.cuh).
    """
    d2 = None
    for k in range(3):
        diff = a[..., :, None, k] - b[..., None, :, k]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2
