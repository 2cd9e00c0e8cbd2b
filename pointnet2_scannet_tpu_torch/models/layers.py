"""Pointwise MLP: Linear (no bias under BatchNorm), BatchNorm, ReLU; its
layer 0 can also run before the neighbourhood gather (pregather). FC: the
same block on (B, C) vectors, the classification head's. RandomDropout and
BNMomentumScheduler: the reference's random-rate dropout and its epoch
schedule of the BatchNorm momentum.

Channels-last: a 1x1 convolution over (B, N, C) or (B, M, K, C) is a Linear
on the last axis. BatchNorm follows flax's nn.BatchNorm, which the JAX
package's chunked train step runs (layers.py:118-126), not torch's:

- train mode normalises with the batch statistics over every axis but the
  last, in at least float32, with flax's fast variance
  max(E[x^2] - E[x]^2, 0), and moves the running statistics by
  m * old + (1 - m) * batch with that *biased* variance (torch would store
  the unbiased one); m is the flax-convention momentum, 0.9 unless a
  forward passes bn_momentum (a float, or a 0-d tensor on any device,
  which moves no value to the host; BNMomentumScheduler gives one an
  epoch);
- eval mode normalises with the running statistics;
- both compute (x - mean) * (rsqrt(var + eps) * scale) + bias, eps 1e-5, in
  flax's order, so the port rounds like the JAX package.

Train mode with a row_mask (the whole-scene step's padded micro-batches)
runs the JAX package's MaskedBatchNorm instead (layers.py:27-91): batch
statistics over the real rows only, with the two-pass variance, normalised
in that module's own order.

With a process group (bn_group, the counterpart of the JAX modules'
bn_axis_name), train mode takes its statistics over the global batch of a
data-parallel run: flax's BatchNorm(axis_name=...) averages each rank's mean
and mean of squares over the ranks, MaskedBatchNorm sums its weighted sums.
The all-reduce is differentiable (parallel/distributed.all_reduce_sum: its
backward sums the cotangents over the ranks), so every rank's gradient is
its share of the global one.

With a tp group (tp_group, tensor parallelism over a dp x tp grid,
parallel/mesh.py) every layer whose width the tp ranks divide is
column-parallel: its Linear holds this rank's rows of the weight (the
output channels of its shard), its input passes column_parallel_input
(whose backward sums the cotangent over the tp ranks) and its BatchNorm
runs on the shard's channels, the statistics summed over bn_group, the dp
group, alone: a channel's statistics are its own. BatchNorm and ReLU act
per channel, so the shard's channels are all-gathered only where the next
op needs a whole row: after each layer but the last, and after the last
where the caller asks (forward(gather=False) leaves the output as shards,
and gather_channels gathers them later, as a set abstraction does after its
max-pool over the neighbours, nsample times fewer bytes). A layer whose
width tp does not divide holds its whole weight on every tp rank and takes
neither collective. The full parameters are made at construction (the
initialisation draws what a single process draws); parallel/
mesh.shard_train_state then takes this rank's slices.

A compute dtype (dtype=torch.bfloat16) follows flax's dtype semantics, not
torch.autocast: the parameters stay float32; each Linear casts its input,
weight and bias to the compute dtype (flax's promote_dtype) and returns it;
BatchNorm takes its statistics in float32, normalises in float32 (x - mean
promotes) and casts its result to the compute dtype at the end (flax's
_normalize).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.parallel.distributed import (
    all_gather_channels,
    all_reduce_sum,
    column_parallel_input,
)

# flax's he_normal draws a normal truncated at two standard deviations and
# divides by this constant, the std of the standard normal truncated there
_TRUNC_STD = 0.87962566103423978
BN_MOMENTUM = 0.9  # flax convention: new = m * old + (1 - m) * batch
BN_EPS = 1e-5


def tp_splits(widths: Sequence[int], tp_group) -> tuple[bool, ...]:
    """Per layer, whether its output channels are split over the ranks of
    tp_group (parallel/mesh.leaf_split's rule for its weight)."""
    tp = dist.get_world_size(tp_group) if tp_group is not None else 1
    return tuple(tp > 1 and w % tp == 0 for w in widths)


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
    dtype: the compute dtype, the JAX module's dtype field (None: compute
    in the input's dtype). bn_group: the process group whose ranks' batches
    the train-mode BatchNorm statistics cover (None: this rank's alone).
    tp_group: the process group that splits the layers' output channels
    (module docstring; None: every layer whole).
    """

    def __init__(
        self,
        in_channels: int,
        widths: Sequence[int],
        *,
        bn: bool = True,
        last_act: bool = True,
        dtype: torch.dtype | None = None,
        bn_group=None,
        tp_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.widths = tuple(widths)
        self.bn = bn
        self.last_act = last_act
        self.dtype = dtype
        self.bn_group = bn_group
        self.tp_group = tp_group
        self.split = tp_splits(self.widths, tp_group)
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

    def forward(self, x: torch.Tensor, row_mask: torch.Tensor | None = None,
                bn_momentum=None, gather: bool = True) -> torch.Tensor:
        """row_mask: optional (B,) 0/1 marks of the real rows; in train mode
        the BatchNorm statistics then leave the padding rows out.
        bn_momentum: the running statistics' flax-convention momentum for
        this call (None: 0.9). gather=False: a split last layer's output
        stays this rank's channel shard (gather_channels gathers it)."""
        n = len(self.widths)
        for i in range(n):
            x = self._bn_act(self._dense(i, x), i, row_mask, bn_momentum)
            if i < n - 1 or gather:
                x = self._whole(i, x)
        return x

    def gather_channels(self, x: torch.Tensor) -> torch.Tensor:
        """The whole channels of the last layer's output from its shards
        (forward(gather=False)); the identity where that layer is whole."""
        return self._whole(len(self.widths) - 1, x)

    def _whole(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return all_gather_channels(x, self.tp_group) if self.split[i] else x

    def _tp_input(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return column_parallel_input(x, self.tp_group) if self.split[i] else x

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's Linear; with a compute dtype, its input, weight and
        bias cast to it first (flax's Dense, dtype=...)."""
        dense = getattr(self, f"dense_{i}")
        x = self._tp_input(i, x)
        dt = self.dtype
        if dt is None:
            return dense(x)
        bias = dense.bias.to(dt) if dense.bias is not None else None
        return F.linear(x.to(dt), dense.weight.to(dt), bias)

    def pregather(
        self,
        xyz: torch.Tensor | None,
        features: torch.Tensor,
        idx: torch.Tensor,
        new_xyz: torch.Tensor | None,
        row_mask: torch.Tensor | None = None,
        bn_momentum=None,
        gather: bool = True,
    ) -> torch.Tensor:
        """forward() over grouped neighbourhoods with layer 0 run on the
        features at source resolution, before the neighbourhood gather (the
        JAX package's PointwiseMLPPregather, layers.py:201-272).

        A pointwise Linear commutes with a row gather, so layer 0 splits its
        weight into xyz columns W_x and feature columns W_f:

            dense_0([gxyz - c | gather(f)]) == gather(f @ W_f^T) + (gxyz - c) @ W_x^T (+ bias)

        and the gather moves widths[0] channels instead of C; it differs
        from forward(grouped) in float summation order only. With a compute
        dtype, the features, the centred xyz (cast after centring) and the
        weight's columns are cast to it before their products, as the JAX
        module casts them (layers.py:254-267).

        Under tp, layer 0's weight holds this rank's rows, so the gather
        (and its scatter-add backward) moves widths[0] / tp channels: the
        gather route is chosen at the call from those narrower rows
        (ops/tuning.gather_route), whose kernels are d and h under the
        default switches, as at full width.

        xyz (B, N, 3) and new_xyz (B, M, 3) for the use_xyz form (both None
        otherwise), features (B, N, C) source rows, idx (B, M, K) ->
        (B, M, K, widths[-1]) (gather as in forward)."""
        dense = self.dense_0
        dt = self.dtype if self.dtype is not None else features.dtype
        w_f = dense.weight if xyz is None else dense.weight[:, 3:]
        features = self._tp_input(0, features)
        x = ops.group_points(features.to(dt) @ w_f.t().to(dt), idx)  # (B, M, K, widths[0] / tp)
        if xyz is not None:
            # the centred 3-channel gather, then the xyz columns of the weight
            gxyz = self._tp_input(0, ops.group_with_idx(idx, xyz, new_xyz, None))
            x = x + gxyz.to(dt) @ dense.weight[:, :3].t().to(dt)
        if dense.bias is not None:
            x = x + dense.bias.to(dt)
        n = len(self.widths)
        x = self._bn_act(x, 0, row_mask, bn_momentum)
        for i in range(1, n):
            x = self._bn_act(self._dense(i, self._whole(i - 1, x)), i, row_mask, bn_momentum)
        return self._whole(n - 1, x) if gather else x

    def _bn_act(self, x: torch.Tensor, i: int, row_mask: torch.Tensor | None, bn_momentum) -> torch.Tensor:
        """Layer i's BatchNorm (+ReLU) after its Linear: MaskedBatchNorm in
        train mode with a row_mask, as the JAX package's _mlp_bn_act routes."""
        if self.bn:
            bn = getattr(self, f"bn_{i}")
            if self.training and row_mask is not None:
                x = masked_batch_norm(x, bn, row_mask, self.dtype, self.bn_group, bn_momentum)
            else:
                x = _batch_norm(x, bn, self.training, self.dtype, self.bn_group, bn_momentum)
        if self.last_act or i < len(self.widths) - 1:
            x = torch.relu(x)
        return x


class FC(nn.Module):
    """Linear(+BatchNorm)(+ReLU) on (B, C) vectors, the JAX package's FC
    (layers.py:295-341), the classification head's block.

    The Linear (fc) has a bias only without BatchNorm. preact=True runs the
    BatchNorm (bn_pre, over the input's channels) and the ReLU before the
    Linear; otherwise they follow it (bn, over its outputs). The Linear and
    the BatchNorm compute as PointwiseMLP's do: with a compute dtype the
    Linear's input, weight and bias are cast to it, and the BatchNorm takes
    its statistics over the batch axis in float32 and casts its result.
    bn_group: the process group of a data-parallel run, whose ranks' global
    batch the train-mode statistics cover (the JAX FC takes no axis name, so
    under the JAX package's shard_map step each device normalises its own
    rows; the port keeps the dp step equal to the global batch's). FC takes
    no tp_group: a preact FC's BatchNorm normalises its input's channels,
    which the leaf rule (parallel/mesh.py) would split, and no
    tensor-parallel path runs the head it builds.
    """

    def __init__(
        self,
        in_size: int,
        out_size: int,
        *,
        bn: bool = False,
        preact: bool = False,
        activation: bool = True,
        dtype: torch.dtype | None = None,
        bn_group=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.use_bn = bn
        self.preact = preact
        self.activation = activation
        self.dtype = dtype
        self.bn_group = bn_group
        if bn and preact:
            self.bn_pre = nn.BatchNorm1d(in_size, eps=BN_EPS, device=device)
        self.fc = nn.Linear(in_size, out_size, bias=not bn, device=device)
        if bn and not preact:
            self.bn = nn.BatchNorm1d(out_size, eps=BN_EPS, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """He-normal weight, zero bias, identity BatchNorm."""
        he_normal_(self.fc.weight, generator)
        if self.fc.bias is not None:
            nn.init.zeros_(self.fc.bias)
        for name in ("bn_pre", "bn"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters()

    def _bn_act(self, x: torch.Tensor, name: str, bn_momentum) -> torch.Tensor:
        if self.use_bn:
            x = _batch_norm(x, getattr(self, name), self.training, self.dtype, self.bn_group, bn_momentum)
        return torch.relu(x) if self.activation else x

    def forward(self, x: torch.Tensor, bn_momentum=None) -> torch.Tensor:
        """bn_momentum as in PointwiseMLP.forward."""
        if self.preact:
            x = self._bn_act(x, "bn_pre", bn_momentum)
        dt = self.dtype
        if dt is None:
            x = self.fc(x)
        else:
            bias = self.fc.bias.to(dt) if self.fc.bias is not None else None
            x = F.linear(x.to(dt), self.fc.weight.to(dt), bias)
        return x if self.preact else self._bn_act(x, "bn", bn_momentum)


class RandomDropout(nn.Module):
    """Dropout at a random rate, the JAX package's RandomDropout
    (layers.py:275): in train mode each call draws one theta ~ U(0, p) and
    keeps every element with probability 1 - theta, and does not rescale
    the kept ones. The draws come from the caller's generator, on x's
    device (JAX's key stream cannot be matched). Identity in eval mode and
    at p = 0."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode RandomDropout needs a torch.Generator (forward(x, generator))")
        theta = torch.rand((), generator=generator, device=x.device) * self.p
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - theta
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


class BNMomentumScheduler:
    """Epoch -> BatchNorm momentum, the JAX package's BNMomentumScheduler
    (layers.py:344). bn_lambda(epoch) gives torch's convention (the new
    batch's weight); step() returns flax's, 1 - bn_lambda(epoch), which a
    forward takes as bn_momentum (a float, or a 0-d tensor)."""

    def __init__(self, bn_lambda, last_epoch: int = -1):
        self.lmbd = bn_lambda
        self.last_epoch = last_epoch

    def step(self, epoch: int | None = None) -> float:
        if epoch is None:
            epoch = self.last_epoch + 1
        self.last_epoch = epoch
        return 1.0 - float(self.lmbd(epoch))


def _momentum(bn_momentum):
    """The flax-convention momentum of a call: bn_momentum, or 0.9."""
    return BN_MOMENTUM if bn_momentum is None else bn_momentum


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool,
                dtype: torch.dtype | None = None, group=None, bn_momentum=None) -> torch.Tensor:
    """flax nn.BatchNorm over the last axis; in train mode it also moves
    bn's running statistics (in place, outside autograd) with momentum
    bn_momentum (None: 0.9). The result is cast to dtype where one is given
    (a bfloat16 x normalises in float32, x - mean promoting). group: flax's axis_name, the mean and the mean of
    squares averaged over its ranks (equal batches on every rank)."""
    if not train:
        mean, var = bn.running_mean, bn.running_var
    else:
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        mean, mean2 = xs.mean(dims), (xs * xs).mean(dims)
        if group is not None:
            stats = all_reduce_sum(torch.cat([mean, mean2]), group) / dist.get_world_size(group)
            mean, mean2 = stats[: mean.numel()], stats[mean.numel() :]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = _momentum(bn_momentum)
            bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean)
            bn.running_var.copy_(m * bn.running_var + (1.0 - m) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean) * mul + bn.bias
    return y if dtype is None else y.to(dtype)


def masked_batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, row_mask: torch.Tensor,
                      dtype: torch.dtype | None = None, group=None, bn_momentum=None) -> torch.Tensor:
    """The JAX package's train-mode MaskedBatchNorm over the last axis: each
    leading row weighs by its 0/1 row_mask (B,), so zero-padded rows leave
    the batch statistics exactly. The weighted mean over max(sum(mask) *
    spatial, 1e-6) points, the two-pass variance max(sum((x - mean)^2 * w)
    / wsum, 0) (a near-constant channel of a small tail micro-batch would
    cancel in the one-pass form), running statistics m * old + (1 - m) *
    batch (m: bn_momentum, None 0.9), and that module's order ((x - mean) *
    rsqrt(var + eps)) * scale + bias, which is not _batch_norm's. In at least float32, as _batch_norm:
    the JAX module casts to float32 whatever x's dtype, which leaves a
    float64 step float32-accurate; the port keeps float64 in float64 and
    rounds like the JAX module in float32. Returns dtype, or x's dtype
    where none is given (the JAX module's out_dtype). group: the JAX
    module's axis_name: wsum and the first sum, then the second, summed over
    its ranks, so the statistics are the global batch's even where ranks
    hold unequal real rows (or none)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xs = x.to(dt)
    mask = row_mask.to(dt)
    w = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    spatial = float(math.prod(x.shape[1:-1])) if x.dim() > 2 else 1.0
    dims = tuple(range(x.dim() - 1))
    wsum, s1 = mask.sum() * spatial, (xs * w).sum(dims)
    if group is not None:
        sums = all_reduce_sum(torch.cat([wsum.reshape(1), s1]), group)
        wsum, s1 = sums[0], sums[1:]
    wsum = torch.clamp(wsum, min=1e-6)
    mean = s1 / wsum
    s2 = ((xs - mean).square() * w).sum(dims)
    if group is not None:
        s2 = all_reduce_sum(s2, group)
    var = torch.clamp(s2 / wsum, min=0.0)
    with torch.no_grad():
        m = _momentum(bn_momentum)
        bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1.0 - m) * var)
    y = (xs - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    return y.to(dtype if dtype is not None else x.dtype)
