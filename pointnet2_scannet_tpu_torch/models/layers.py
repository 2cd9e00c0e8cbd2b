"""Pointwise MLP: Linear (no bias under BatchNorm), BatchNorm, ReLU; its
layer 0 can also run before the neighbourhood gather (pregather).

Channels-last: a 1x1 convolution over (B, N, C) or (B, M, K, C) is a Linear
on the last axis. BatchNorm follows flax's nn.BatchNorm, which the JAX
package's chunked train step runs (layers.py:118-126), not torch's:

- train mode normalises with the batch statistics over every axis but the
  last, in at least float32, with flax's fast variance
  max(E[x^2] - E[x]^2, 0), and moves the running statistics by
  0.9 * old + 0.1 * batch with that *biased* variance (torch would store
  the unbiased one);
- eval mode normalises with the running statistics;
- both compute (x - mean) * (rsqrt(var + eps) * scale) + bias, eps 1e-5, in
  flax's order, so the port rounds like the JAX package.

Train mode with a row_mask (the whole-scene step's padded micro-batches)
runs the JAX package's MaskedBatchNorm instead (layers.py:27-91): batch
statistics over the real rows only, with the two-pass variance, normalised
in that module's own order.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from pointnet2_scannet_tpu_torch import ops

# flax's he_normal draws a normal truncated at two standard deviations and
# divides by this constant, the std of the standard normal truncated there
_TRUNC_STD = 0.87962566103423978
BN_MOMENTUM = 0.9  # flax convention: new = m * old + (1 - m) * batch
BN_EPS = 1e-5


def he_normal_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """flax's he_normal for a Linear weight (out, in): truncated normal with
    variance 2 / fan_in."""
    std = math.sqrt(2.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class PointwiseMLP(nn.Module):
    """Stack of Linear(+BN)(+ReLU) layers on the last axis.

    Parameters are named dense_{i} and bn_{i}, after the JAX package's tree.
    last_act=False leaves the final layer without ReLU (a head's logits).
    """

    def __init__(
        self,
        in_channels: int,
        widths: Sequence[int],
        *,
        bn: bool = True,
        last_act: bool = True,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.widths = tuple(widths)
        self.bn = bn
        self.last_act = last_act
        c = in_channels
        for i, w in enumerate(self.widths):
            self.add_module(f"dense_{i}", nn.Linear(c, w, bias=not bn, device=device))
            if bn:
                self.add_module(f"bn_{i}", nn.BatchNorm1d(w, eps=BN_EPS, device=device))
            c = w

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """He-normal weights, zero biases, identity BatchNorm."""
        for i in range(len(self.widths)):
            dense = getattr(self, f"dense_{i}")
            he_normal_(dense.weight, generator)
            if dense.bias is not None:
                nn.init.zeros_(dense.bias)
            if self.bn:
                getattr(self, f"bn_{i}").reset_parameters()

    def forward(self, x: torch.Tensor, row_mask: torch.Tensor | None = None) -> torch.Tensor:
        """row_mask: optional (B,) 0/1 marks of the real rows; in train mode
        the BatchNorm statistics then leave the padding rows out."""
        for i in range(len(self.widths)):
            x = self._bn_act(getattr(self, f"dense_{i}")(x), i, row_mask)
        return x

    def pregather(
        self,
        xyz: torch.Tensor | None,
        features: torch.Tensor,
        idx: torch.Tensor,
        new_xyz: torch.Tensor | None,
        row_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """forward() over grouped neighbourhoods with layer 0 run on the
        features at source resolution, before the neighbourhood gather (the
        JAX package's PointwiseMLPPregather, layers.py:201-272).

        A pointwise Linear commutes with a row gather, so layer 0 splits its
        weight into xyz columns W_x and feature columns W_f:

            dense_0([gxyz - c | gather(f)]) == gather(f @ W_f^T) + (gxyz - c) @ W_x^T (+ bias)

        and the gather moves widths[0] channels instead of C; it differs
        from forward(grouped) in float summation order only.

        xyz (B, N, 3) and new_xyz (B, M, 3) for the use_xyz form (both None
        otherwise), features (B, N, C) source rows, idx (B, M, K) ->
        (B, M, K, widths[-1])."""
        dense = self.dense_0
        w_f = dense.weight if xyz is None else dense.weight[:, 3:]
        x = ops.group_points(features @ w_f.t(), idx)  # (B, M, K, widths[0])
        if xyz is not None:
            # the centred 3-channel gather, then the xyz columns of the weight
            x = x + ops.group_with_idx(idx, xyz, new_xyz, None) @ dense.weight[:, :3].t()
        if dense.bias is not None:
            x = x + dense.bias
        x = self._bn_act(x, 0, row_mask)
        for i in range(1, len(self.widths)):
            x = self._bn_act(getattr(self, f"dense_{i}")(x), i, row_mask)
        return x

    def _bn_act(self, x: torch.Tensor, i: int, row_mask: torch.Tensor | None) -> torch.Tensor:
        """Layer i's BatchNorm (+ReLU) after its Linear: MaskedBatchNorm in
        train mode with a row_mask, as the JAX package's _mlp_bn_act routes."""
        if self.bn:
            bn = getattr(self, f"bn_{i}")
            if self.training and row_mask is not None:
                x = masked_batch_norm(x, bn, row_mask)
            else:
                x = _batch_norm(x, bn, self.training)
        if self.last_act or i < len(self.widths) - 1:
            x = torch.relu(x)
        return x


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool) -> torch.Tensor:
    """flax nn.BatchNorm over the last axis; in train mode it also moves
    bn's running statistics (in place, outside autograd)."""
    if not train:
        mean, var = bn.running_mean, bn.running_var
    else:
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        mean = xs.mean(dims)
        var = torch.clamp((xs * xs).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = BN_MOMENTUM
            bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean)
            bn.running_var.copy_(m * bn.running_var + (1.0 - m) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean) * mul + bn.bias


def masked_batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, row_mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's train-mode MaskedBatchNorm over the last axis: each
    leading row weighs by its 0/1 row_mask (B,), so zero-padded rows leave
    the batch statistics exactly. The weighted mean over max(sum(mask) *
    spatial, 1e-6) points, the two-pass variance max(sum((x - mean)^2 * w)
    / wsum, 0) (a near-constant channel of a small tail micro-batch would
    cancel in the one-pass form), running statistics 0.9 * old + 0.1 *
    batch, and that module's order ((x - mean) * rsqrt(var + eps)) * scale
    + bias, which is not _batch_norm's. In at least float32, as _batch_norm:
    the JAX module casts to float32 whatever x's dtype, which leaves a
    float64 step float32-accurate; the port keeps float64 in float64 and
    rounds like the JAX module in float32. Returns x's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xs = x.to(dt)
    mask = row_mask.to(dt)
    w = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    spatial = float(math.prod(x.shape[1:-1])) if x.dim() > 2 else 1.0
    dims = tuple(range(x.dim() - 1))
    wsum = torch.clamp(mask.sum() * spatial, min=1e-6)
    mean = (xs * w).sum(dims) / wsum
    var = torch.clamp(((xs - mean).square() * w).sum(dims) / wsum, min=0.0)
    with torch.no_grad():
        m = BN_MOMENTUM
        bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1.0 - m) * var)
    y = (xs - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    return y.to(x.dtype)
