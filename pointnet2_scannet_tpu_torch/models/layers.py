"""Pointwise MLP: Linear (no bias under BatchNorm), BatchNorm, ReLU.

Channels-last: a 1x1 convolution over (B, N, C) or (B, M, K, C) is a Linear
on the last axis. BatchNorm runs in eval mode only (eps 1e-5, running
statistics), computed in flax's order — (x - mean) * (rsqrt(var + eps) *
scale) + bias — so the port rounds like the JAX package. Train-mode
BatchNorm (the JAX package keeps the biased batch variance) is ROADMAP queue
1, item 5.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

# flax's he_normal draws a normal truncated at two standard deviations and
# divides by this constant, the std of the standard normal truncated there
_TRUNC_STD = 0.87962566103423978


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
                self.add_module(f"bn_{i}", nn.BatchNorm1d(w, eps=1e-5, device=device))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet (ROADMAP queue 1, item 5); "
                "call .eval() first"
            )
        n = len(self.widths)
        for i in range(n):
            x = getattr(self, f"dense_{i}")(x)
            if self.bn:
                bn = getattr(self, f"bn_{i}")
                mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
                x = (x - bn.running_mean) * mul + bn.bias
            if self.last_act or i < n - 1:
                x = torch.relu(x)
        return x
