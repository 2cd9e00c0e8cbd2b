"""PointNet++ semantic segmentation (SSG and MSG).

The architecture of the JAX package's models/pointnet2.py: four set
abstractions (one grouping scale each for SSG, two for MSG), four feature
propagations run deepest first, then the head cls_fc (Linear, BN, ReLU),
Dropout and cls_out (Linear and BN on the logits, no ReLU). Modules are named after the JAX parameter tree (sa_{k}.mlp_{s},
fp_{k}.mlp, cls_fc, cls_out), so models/convert.py maps one to one. Input
(B, N, 3 + C) channels-last; output (B, N, num_classes) float32.

model.train() / model.eval() switch BatchNorm (batch statistics and running
updates, or running statistics) and the head Dropout, which in train mode
zeroes each activation with probability spec.dropout and scales the kept
ones by 1 / (1 - p), like flax's nn.Dropout. Its mask comes from the
torch.Generator handed to forward, so a seed fixes it.

dtype=torch.bfloat16 is the JAX package's bfloat16 compute dtype
(config.ModelConfig.compute_dtype "bfloat16", scripts/train.py --bf16):
the parameters, BatchNorm statistics and optimizer state stay float32,
every MLP computes in bfloat16 (models/layers.py), grouping moves packed
bfloat16 rows (ops/neighborhood.py), and the logits come out in bfloat16
and are returned as float32, as the JAX model returns them.

tp_group (tensor parallelism, models/layers.py) splits every layer whose
width the tp ranks divide, the head's too: cls_fc's output is gathered
before the Dropout (every tp rank of a dp index draws the same mask from
the same seed), and the logits of cls_out (split where tp divides
num_classes, 20 at tp 2 and 4) are gathered before they are returned, so
the loss sees whole rows.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP
from pointnet2_scannet_tpu_torch.models.modules import FeaturePropagation, SetAbstraction

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # ModelConfig.compute_dtype


@dataclasses.dataclass(frozen=True)
class PointNet2Spec:
    """Static architecture description."""

    num_classes: int
    input_channels: int  # feature channels beyond xyz
    npoints: tuple[int, ...]
    radii: tuple[tuple[float, ...], ...]  # per level, per scale
    nsamples: tuple[tuple[int, ...], ...]
    sa_mlps: tuple[tuple[tuple[int, ...], ...], ...]  # level -> scale -> widths
    fp_mlps: tuple[tuple[int, ...], ...]
    cls_fc: tuple[int, ...] = (128,)
    dropout: float = 0.5
    use_xyz: bool = True
    bn: bool = True

    @property
    def sa_out_channels(self) -> tuple[int, ...]:
        return tuple(sum(m[-1] for m in level) for level in self.sa_mlps)

    @property
    def skip_channels(self) -> tuple[int, ...]:
        return (self.input_channels,) + self.sa_out_channels


def ssg_spec(num_classes: int = 20, input_channels: int = 0) -> PointNet2Spec:
    """Single-scale grouping: npoints 1024/256/64/16, radii 0.1/0.2/0.4/0.8,
    32 neighbours per level."""
    return PointNet2Spec(
        num_classes=num_classes,
        input_channels=input_channels,
        npoints=(1024, 256, 64, 16),
        radii=((0.1,), (0.2,), (0.4,), (0.8,)),
        nsamples=((32,), (32,), (32,), (32,)),
        sa_mlps=(
            ((32, 32, 64),),
            ((64, 64, 128),),
            ((128, 128, 256),),
            ((256, 256, 512),),
        ),
        fp_mlps=((128, 128), (256, 128), (256, 256), (256, 256)),
    )


def msg_spec(num_classes: int = 20, input_channels: int = 0) -> PointNet2Spec:
    """Multi-scale grouping: npoints 1024/256/64/16, two radii per level
    (0.05/0.1, 0.1/0.2, 0.2/0.4, 0.4/0.8) with 16 and 32 neighbours, one MLP
    per scale."""
    return PointNet2Spec(
        num_classes=num_classes,
        input_channels=input_channels,
        npoints=(1024, 256, 64, 16),
        radii=((0.05, 0.1), (0.1, 0.2), (0.2, 0.4), (0.4, 0.8)),
        nsamples=((16, 32), (16, 32), (16, 32), (16, 32)),
        sa_mlps=(
            ((16, 16, 32), (32, 32, 64)),
            ((64, 64, 128), (64, 96, 128)),
            ((128, 196, 256), (128, 196, 256)),
            ((256, 256, 512), (256, 384, 512)),
        ),
        fp_mlps=((128, 128), (256, 256), (512, 512), (512, 512)),
    )


class PointNet2SemSeg(nn.Module):
    """Encoder-decoder PointNet++ over fixed-size point columns.

    Built on the CPU, initialised from `generator` (flax's he_normal, zero
    biases, identity BatchNorm), then moved to `device`; the module starts in
    eval mode. dtype: the compute dtype (None, or torch.bfloat16). bn_group:
    the process group of a data-parallel run (the JAX model's bn_axis_name):
    train-mode BatchNorm statistics cover its ranks' global batch; None
    (one device) keeps them local. tp_group: the tensor-parallel group
    (module docstring; None: every layer whole).
    """

    def __init__(
        self,
        spec: PointNet2Spec,
        *,
        dtype: torch.dtype | None = None,
        bn_group=None,
        tp_group=None,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.bn_group = bn_group
        self.tp_group = tp_group
        groups = {"bn_group": bn_group, "tp_group": tp_group}
        c = spec.input_channels
        for lvl in range(len(spec.npoints)):
            sa = SetAbstraction(
                spec.npoints[lvl], spec.radii[lvl], spec.nsamples[lvl],
                spec.sa_mlps[lvl], c, use_xyz=spec.use_xyz, bn=spec.bn, dtype=dtype, **groups,
            )
            self.add_module(f"sa_{lvl}", sa)
            c = sa.out_channels
        for lvl in reversed(range(len(spec.fp_mlps))):
            fp = FeaturePropagation(
                spec.fp_mlps[lvl], c + spec.skip_channels[lvl], bn=spec.bn, dtype=dtype, **groups
            )
            self.add_module(f"fp_{lvl}", fp)
            c = spec.fp_mlps[lvl][-1]
        self.cls_fc = PointwiseMLP(c, spec.cls_fc, bn=spec.bn, dtype=dtype, **groups)
        self.cls_out = PointwiseMLP(
            spec.cls_fc[-1], (spec.num_classes,), bn=spec.bn, last_act=False, dtype=dtype, **groups,
        )
        for m in self.modules():
            if isinstance(m, PointwiseMLP):
                m.reset_parameters(generator)
        if device is not None:
            self.to(device)
        self.eval()

    def forward(
        self,
        pc: torch.Tensor,
        generator: torch.Generator | None = None,
        row_mask: torch.Tensor | None = None,
        bn_momentum=None,
    ) -> torch.Tensor:
        """generator: the Dropout mask's random stream, on pc's device; needed
        in train mode when spec.dropout > 0. row_mask: optional (B,) 0/1
        marks of the real rows; in train mode every BatchNorm's batch
        statistics leave the padding rows out (MaskedBatchNorm, the
        whole-scene step's padded last micro-batch). bn_momentum: every
        BatchNorm's flax-convention momentum for this call, a float or a 0-d
        tensor (None: 0.9; models.layers.BNMomentumScheduler gives one an
        epoch)."""
        spec = self.spec
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:].contiguous() if pc.shape[-1] > 3 else None
        l_xyz = [xyz]
        l_feats = [features]
        for lvl in range(len(spec.npoints)):
            new_xyz, new_feats = getattr(self, f"sa_{lvl}")(l_xyz[lvl], l_feats[lvl], row_mask, bn_momentum)
            l_xyz.append(new_xyz)
            l_feats.append(new_feats)
        for lvl in reversed(range(len(spec.fp_mlps))):  # deepest level first
            l_feats[lvl] = getattr(self, f"fp_{lvl}")(
                l_xyz[lvl], l_xyz[lvl + 1], l_feats[lvl], l_feats[lvl + 1], row_mask, bn_momentum
            )
        h = self.cls_fc(l_feats[0], row_mask, bn_momentum)
        if self.training and spec.dropout > 0.0:
            h = _dropout(h, spec.dropout, generator)
        return self.cls_out(h, row_mask, bn_momentum).to(torch.float32)


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate)."""
    if generator is None:
        raise ValueError("train-mode Dropout needs a torch.Generator (forward(pc, generator))")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def get_model(
    num_classes: int,
    is_msg: bool = True,
    input_channels: int = 6,
    use_xyz: bool = True,
    bn: bool = True,
    dtype: torch.dtype | None = None,
    bn_group=None,
    *,
    tp_group=None,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> PointNet2SemSeg:
    """Factory with the JAX package's get_model arguments and defaults (MSG
    unless is_msg=False; dtype None, or torch.bfloat16; bn_group, the JAX
    bn_axis_name, None); tp_group: tensor parallelism (None: none)."""
    spec = dataclasses.replace(
        (msg_spec if is_msg else ssg_spec)(num_classes, input_channels), use_xyz=use_xyz, bn=bn
    )
    return PointNet2SemSeg(spec, dtype=dtype, bn_group=bn_group, tp_group=tp_group, device=device,
                           generator=generator)


def model_from_config(cfg, **kwargs) -> PointNet2SemSeg:
    """get_model for a RunConfig: its model fields, input channels and
    compute dtype; kwargs (bn_group, tp_group, device, generator) pass
    through."""
    return get_model(
        num_classes=cfg.model.num_classes,
        is_msg=cfg.model.is_msg,
        input_channels=cfg.data.input_channels,
        use_xyz=cfg.model.use_xyz,
        bn=cfg.model.bn,
        dtype=COMPUTE_DTYPES[cfg.model.compute_dtype],
        **kwargs,
    )
