"""Shared geometry helper for the point ops."""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor, *, mode: str = "exact") -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) squared distances.

    mode "exact": the difference form ((dx*dx + dy*dy) + dz*dz), each
    operation rounded on its own: bit-comparable with the JAX package's
    pairwise_sqdist(mode="exact") and with the CUDA kernels
    (csrc/sqdist.cuh). mode "dot": |a|^2 + |b|^2 - 2 a.b with a.b an einsum,
    the JAX package's "dot" form (bit for bit on the CPU); it can go
    slightly negative. Only the plain versions of the point ops read it:
    the kernels compute the exact form, as the JAX Pallas kernels do.
    """
    if mode == "dot":
        a2 = (a * a).sum(-1)[..., :, None]
        b2 = (b * b).sum(-1)[..., None, :]
        return a2 + b2 - 2.0 * torch.einsum("...mk,...nk->...mn", a, b)
    if mode != "exact":
        raise ValueError(f"unknown mode {mode!r}")
    d2 = None
    for k in range(3):
        diff = a[..., :, None, k] - b[..., None, :, k]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2
