"""The numbers that decide `correct`, each compared with its limit
(limits/<cell>.json).

Training (the first call's K steps, program against reference):
- loss1_gap: |loss_p - loss_r| / |loss_r| of the first step (the forward
  and the loss from the same weights);
- loss2_gap: the same of the second step, whose weights the first step's
  backward and Adam update made;
- update_gap: the median over the leaves of the gap between the program's
  and the reference's norms of the leaf's change over the K steps, over
  the larger of the reference leaf's change and the median leaf's;
- worst_update_gap: the largest of those gaps, which a fault confined to
  a few leaves (one layer's gradient, one BatchNorm's bias) moves and the
  median does not.
Later steps' losses are not compared: Adam's first updates are nearly
lr * sign(gradient), so a gradient element at rounding level flips its
update, and those differences grow from step to step; two runs of the
reference itself, whose gather backward adds with atomics, read apart by
as much (PERF.md). They are reported beside the compared numbers (detail).
Leaves whose reference first moment is under a thousandth of the median
leaf's (gradients nought to rounding) are left out of the leaf numbers.
"""

from __future__ import annotations

import numpy as np
import torch

MOMENT_FLOOR = 1e-3  # of the median leaf's reference moment


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def _leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep: list[str]) -> dict[str, float]:
    median = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep}


def train_numbers(prog: dict, ref: dict, start: dict, detail: dict | None = None) -> dict[str, float]:
    """prog / ref: {"losses" (K,), "params", "moments"} after the K steps;
    start: the weights both began from. detail: filled with the numbers
    that are reported and not compared (every step's loss gap, the worst
    moment's gap and leaf, the worst change's leaf)."""
    lp, lr = np.asarray(prog["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    losses = np.abs(lp - lr) / np.abs(lr)
    m_ref = _norms(ref["moments"])
    median = float(np.median(list(m_ref.values())))
    keep = [k for k in m_ref if m_ref[k] >= MOMENT_FLOOR * median]
    moments = _leaf_gaps(_norms({k: prog["moments"][k] for k in keep}), m_ref, keep)
    updates = _leaf_gaps(_norms({k: prog["params"][k].detach().to(start[k].device) - start[k] for k in keep}),
                         _norms({k: ref["params"][k].detach() - start[k] for k in keep}), keep)
    if detail is not None:
        worst_m, worst_u = max(moments, key=moments.get), max(updates, key=updates.get)
        detail.update(loss_gaps=[float(x) for x in losses], worst_moment_gap=moments[worst_m],
                      worst_moment_leaf=worst_m, worst_update_leaf=worst_u,
                      median_moment_gap=float(np.median(list(moments.values()))), left_out=len(m_ref) - len(keep))
    return {"loss1_gap": float(losses[0]), "loss2_gap": float(losses[1]),
            "update_gap": float(np.median(list(updates.values()))), "worst_update_gap": max(updates.values())}

