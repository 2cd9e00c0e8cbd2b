"""Class-weighted cross-entropy, the JAX package's engine/loss.py.

The per-point softmax cross-entropy is scaled by the per-point weights
(label weight of the point's class) and averaged over ALL points, zero-weight
ones included; with a row_mask the mean runs over the real batch rows only,
so a padded trailing batch gives the loss of the ragged batch it stands for.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def softmax_ce_integer(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., K) logits x (...) int labels -> (...) cross-entropy, in the JAX
    package's form: max-shifted logits (the shift carries no gradient) and a
    one-hot product that picks the label's logit."""
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.unsqueeze(-1) == classes).to(shifted.dtype)
    label_logits = (shifted * onehot).sum(dim=-1)
    log_normalizers = torch.log(torch.exp(shifted).sum(dim=-1))
    return log_normalizers - label_logits


def weighted_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean over all points of CE * weight.

    logits (B, N, K); labels (B, N) int; weights (B, N); row_mask optional
    (B,) 0/1 marks of the real (non-padding) rows.
    """
    ce = softmax_ce_integer(logits, labels)
    if row_mask is None:
        return (ce * weights).mean()
    m = row_mask[:, None]
    denom = torch.clamp(row_mask.sum(), min=1.0) * ce.shape[-1]
    return (ce * weights * m).sum() / denom


def weighted_cross_entropy_sharded(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    row_mask: torch.Tensor | None,
    group,
) -> torch.Tensor:
    """This rank's share of weighted_cross_entropy over the global batch of
    a data-parallel run (the JAX package's weighted_cross_entropy_sharded,
    loss.py:64-81): the local weighted sum over the global count, the rows
    (or points) counted across the ranks of group. The shares sum over the
    ranks to the global loss, so each rank's backward of its share, summed
    over the ranks, is the global gradient.

    Without a row_mask, the local mean times n_local / n_global, the same
    quotient, which one rank computes as weighted_cross_entropy does.

    Capture-safe: the counts are made and summed on the device (a fill, not
    a copy from host memory), so the step can run inside a CUDA graph."""
    ce = softmax_ce_integer(logits, labels)
    if row_mask is None:
        n = torch.full((), ce.numel(), dtype=ce.dtype, device=ce.device)
        total = n.clone()
        dist.all_reduce(total, group=group)
        return (ce * weights).mean() * (n / total)
    rows = row_mask.sum().detach().clone()
    dist.all_reduce(rows, group=group)
    return (ce * weights * row_mask[:, None]).sum() / (torch.clamp(rows, min=1.0) * ce.shape[-1])
