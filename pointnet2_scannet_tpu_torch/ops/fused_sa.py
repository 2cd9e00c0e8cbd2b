"""The SA1 row gather fused with the layer-0 matrix product (the JAX
package's experiment in scripts/bench_fused_sa.py), dispatched by device."""

from __future__ import annotations

import torch

from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel, on_cuda


def fused_gather_mm(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, J) int32 x (C, F) -> (B, J, F) = gather(src, idx) @ w.

    The TPU kernel's domain: J and N multiples of 128 (it tiles the indices
    by 128 and silently drops those at or past 128 * (N // 128)); outside it
    this raises ValueError. Like the TPU kernel it has no gradient."""
    if src.dim() != 3 or idx.dim() != 2 or w.dim() != 2:
        raise ValueError(f"shapes {tuple(src.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}: "
                         "want (B, N, C), (B, J), (C, F)")
    n, j = src.shape[1], idx.shape[1]
    if n % 128 or j % 128:
        raise ValueError(f"fused_gather_mm takes N and J multiples of 128, got N={n}, J={j}")
    if torch.is_grad_enabled() and (src.requires_grad or w.requires_grad):
        raise RuntimeError("fused_gather_mm has no gradient (nor has the TPU kernel)")
    if on_cuda(src):
        if torch.bfloat16 in (src.dtype, w.dtype):
            raise NotImplementedError("bfloat16 operands of fused_gather_mm (kernel k) are not "
                                      "ported yet (ROADMAP queue 2, R9)")
        return fused_gather_mm_kernel.fused_gather_mm_cuda(src, idx.to(torch.int32), w)
    return fused_gather_mm_kernel.fused_gather_mm_plain(src, idx, w)
