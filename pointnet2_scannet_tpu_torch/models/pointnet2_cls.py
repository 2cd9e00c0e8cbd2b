"""PointNet++ shape classification (SSG and MSG), the JAX package's
models/pointnet2_cls.py.

The standard public recipe, as the JAX specs hard-code it: SSG is
SA(512, r 0.2, K 32, [64, 64, 128]) -> SA(128, r 0.4, K 64, [128, 128, 256])
-> SA(group-all, [256, 512, 1024]) -> FC 512 -> FC 256 -> logits, Dropout
0.5 after each FC; MSG widens the first two levels to three radii each
(three ball-query launches a level). Modules are named after the JAX
parameter tree (sa1..sa3 with mlp_{s}, fc1, fc2, head), so
models/convert.py maps one to one.

Input (B, N, 3 + C): xyz, then C per-point features (0 in the shape
trainers). The group-all level pools each cloud into one (B, 1, 1024)
vector, flattened to (B, 1024) for the head, whose BatchNorm then takes its
statistics over the batch axis alone. Output (B, num_classes) float32.

dtype=torch.bfloat16 computes every MLP and FC in bfloat16, as the JAX
model's dtype does; xyz stays float32 for FPS and the ball queries, as in
the port's segmentation models (the JAX shape families cast xyz to the
compute dtype too).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pointnet2_scannet_tpu_torch.models.layers import FC, PointwiseMLP
from pointnet2_scannet_tpu_torch.models.modules import SetAbstraction
from pointnet2_scannet_tpu_torch.models.pointnet2 import _dropout


@dataclasses.dataclass(frozen=True)
class PointNet2ClsSpec:
    """One SA tower + FC head. Each SA level: (npoint|None, radii, ks, mlps)."""

    sa_levels: tuple
    fc_widths: tuple = (512, 256)
    dropout: float = 0.5


def cls_ssg_spec() -> PointNet2ClsSpec:
    return PointNet2ClsSpec(
        sa_levels=(
            (512, (0.2,), (32,), ((64, 64, 128),)),
            (128, (0.4,), (64,), ((128, 128, 256),)),
            (None, (), (), ((256, 512, 1024),)),
        )
    )


def cls_msg_spec() -> PointNet2ClsSpec:
    return PointNet2ClsSpec(
        sa_levels=(
            (512, (0.1, 0.2, 0.4), (16, 32, 128), ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
            (128, (0.2, 0.4, 0.8), (32, 64, 128), ((64, 64, 128), (128, 128, 256), (128, 128, 256))),
            (None, (), (), ((256, 512, 1024),)),
        )
    )


def build_sa_tower(module: nn.Module, sa_levels, in_channels: int, **kwargs) -> list[int]:
    """Add sa1.. (SetAbstraction) to module for sa_levels; returns each
    level's output channels."""
    out = []
    c = in_channels
    for i, (npoint, radii, ks, mlps) in enumerate(sa_levels):
        sa = SetAbstraction(npoint, radii, ks, mlps, c, **kwargs)
        module.add_module(f"sa{i + 1}", sa)
        c = sa.out_channels
        out.append(c)
    return out


def init_weights(module: nn.Module, generator: torch.Generator | None) -> None:
    """flax's he_normal weights, zero biases, identity BatchNorm, in module
    order."""
    for m in module.modules():
        if isinstance(m, (PointwiseMLP, FC)):
            m.reset_parameters(generator)


class PointNet2Cls(nn.Module):
    """(B, N, 3 + C) point clouds -> (B, num_classes) logits.

    Built on the CPU, initialised from `generator`, then moved to `device`;
    the module starts in eval mode. bn_group: the process group of a
    data-parallel run (every BatchNorm's statistics over its ranks)."""

    def __init__(
        self,
        num_classes: int,
        spec: PointNet2ClsSpec,
        *,
        input_channels: int = 0,
        use_xyz: bool = True,
        bn: bool = True,
        dtype: torch.dtype | None = None,
        bn_group=None,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.spec = spec
        self.num_classes = num_classes
        self.dtype = dtype
        self.bn_group = bn_group
        c = build_sa_tower(self, spec.sa_levels, input_channels, use_xyz=use_xyz, bn=bn, dtype=dtype,
                           bn_group=bn_group)[-1]
        for j, width in enumerate(spec.fc_widths):
            self.add_module(f"fc{j + 1}", FC(c, width, bn=bn, dtype=dtype, bn_group=bn_group))
            c = width
        self.head = FC(c, num_classes, bn=False, activation=False, dtype=dtype)
        init_weights(self, generator)
        if device is not None:
            self.to(device)
        self.eval()

    def forward(self, pc: torch.Tensor, generator: torch.Generator | None = None,
                bn_momentum=None) -> torch.Tensor:
        """generator: the Dropout masks' stream, on pc's device; needed in
        train mode when spec.dropout > 0. bn_momentum as in
        PointNet2SemSeg.forward."""
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:].contiguous() if pc.shape[-1] > 3 else None
        for i in range(len(self.spec.sa_levels)):
            xyz, features = getattr(self, f"sa{i + 1}")(xyz, features, None, bn_momentum)
        x = features.reshape(features.shape[0], -1)  # (B, 1024): the global vector
        for j in range(len(self.spec.fc_widths)):
            x = getattr(self, f"fc{j + 1}")(x, bn_momentum)
            if self.training and self.spec.dropout > 0.0:
                x = _dropout(x, self.spec.dropout, generator)
        return self.head(x, bn_momentum).to(torch.float32)


def get_cls_model(
    num_classes: int,
    is_msg: bool = False,
    *,
    input_channels: int = 0,
    use_xyz: bool = True,
    bn: bool = True,
    dtype: torch.dtype | None = None,
    bn_group=None,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> PointNet2Cls:
    """The JAX get_cls_model's arguments and defaults (SSG unless is_msg)."""
    return PointNet2Cls(
        num_classes, cls_msg_spec() if is_msg else cls_ssg_spec(), input_channels=input_channels,
        use_xyz=use_xyz, bn=bn, dtype=dtype, bn_group=bn_group, device=device, generator=generator,
    )
