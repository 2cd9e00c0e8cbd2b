"""PointNet++ part segmentation (SSG and MSG), the JAX package's
models/pointnet2_partseg.py.

The standard public recipe, as the JAX specs hard-code it: SSG is
SA(512, r 0.2, K 32, [64, 64, 128]) -> SA(128, r 0.4, K 64, [128, 128, 256])
-> SA(group-all, [256, 512, 1024]); FP [256, 256] -> [256, 128] ->
[128, 128, 128]; head_fc (128, BN, ReLU), Dropout 0.5, head_out (no BN, no
ReLU). MSG takes three radii at SA1 (three ball-query launches) and two at
SA2 (one two-radius query), where c_in 323 >= 2 * widths[0] puts layer 0
before the gather (the pregather) in float32. Modules are named after the
JAX parameter tree (sa1..sa3, fp3..fp1, head_fc, head_out).

Input (B, N, 3 + C + num_categories): xyz, C per-point features (0 in the
shape trainers), then the category one-hot, constant over each cloud. The
one-hot bypasses the SA tower and joins the last FP level's skip as
[one-hot, xyz, features]; the deepest FP level takes no known points (the
group-all level has none) and broadcasts the global feature onto every
point. Output (B, N, num_parts) float32.

dtype=torch.bfloat16: every MLP computes in bfloat16, the last skip is
cast to it, and xyz stays float32 for the geometry ops (models/pointnet2_cls.py).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP
from pointnet2_scannet_tpu_torch.models.modules import FeaturePropagation
from pointnet2_scannet_tpu_torch.models.pointnet2 import _dropout
from pointnet2_scannet_tpu_torch.models.pointnet2_cls import build_sa_tower, init_weights


@dataclasses.dataclass(frozen=True)
class PointNet2PartSegSpec:
    """SA tower (npoint|None, radii, ks, mlps) + FP decoder + head."""

    sa_levels: tuple
    fp_mlps: tuple  # deepest first: fp_mlps[0] refines the coarsest skip
    head_width: int = 128
    dropout: float = 0.5


def partseg_ssg_spec() -> PointNet2PartSegSpec:
    return PointNet2PartSegSpec(
        sa_levels=(
            (512, (0.2,), (32,), ((64, 64, 128),)),
            (128, (0.4,), (64,), ((128, 128, 256),)),
            (None, (), (), ((256, 512, 1024),)),
        ),
        fp_mlps=((256, 256), (256, 128), (128, 128, 128)),
    )


def partseg_msg_spec() -> PointNet2PartSegSpec:
    return PointNet2PartSegSpec(
        sa_levels=(
            (512, (0.1, 0.2, 0.4), (32, 64, 128), ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
            (128, (0.4, 0.8), (64, 128), ((128, 128, 256), (128, 196, 256))),
            (None, (), (), ((256, 512, 1024),)),
        ),
        fp_mlps=((256, 256), (256, 128), (128, 128)),
    )


class PointNet2PartSeg(nn.Module):
    """(B, N, 3 + C + num_categories) -> (B, N, num_parts) logits.

    Built on the CPU, initialised from `generator`, then moved to `device`;
    the module starts in eval mode. bn_group as in PointNet2Cls."""

    def __init__(
        self,
        num_parts: int,
        num_categories: int,
        spec: PointNet2PartSegSpec,
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
        self.num_parts = num_parts
        self.num_categories = num_categories
        self.dtype = dtype
        self.bn_group = bn_group
        sa_out = build_sa_tower(self, spec.sa_levels, input_channels, use_xyz=use_xyz, bn=bn, dtype=dtype,
                                bn_group=bn_group)
        # the features each level's skip carries: the last skip [one-hot, xyz, features]
        skips = [num_categories + 3 + input_channels] + sa_out[:-1]
        c = sa_out[-1]
        n = len(spec.sa_levels)
        for j, widths in enumerate(spec.fp_mlps):
            lvl = n - 1 - j  # deepest skip first
            self.add_module(f"fp{lvl + 1}", FeaturePropagation(widths, c + skips[lvl], bn=bn, dtype=dtype,
                                                               bn_group=bn_group))
            c = widths[-1]
        self.head_fc = PointwiseMLP(c, (spec.head_width,), bn=bn, dtype=dtype, bn_group=bn_group)
        self.head_out = PointwiseMLP(spec.head_width, (num_parts,), bn=False, last_act=False, dtype=dtype)
        init_weights(self, generator)
        if device is not None:
            self.to(device)
        self.eval()

    def forward(self, pc: torch.Tensor, generator: torch.Generator | None = None,
                bn_momentum=None) -> torch.Tensor:
        """generator: the Dropout mask's stream, on pc's device; needed in
        train mode when spec.dropout > 0. bn_momentum as in
        PointNet2SemSeg.forward."""
        k = self.num_categories
        if pc.shape[-1] < 3 + k:
            raise ValueError(f"expected >= {3 + k} channels (xyz + features + {k} one-hot), "
                             f"got {pc.shape[-1]}")
        xyz = pc[..., :3].contiguous()
        onehot = pc[..., pc.shape[-1] - k:]
        features = pc[..., 3 : pc.shape[-1] - k].contiguous() if pc.shape[-1] > 3 + k else None
        l_xyz, l_feats = [xyz], [features]
        for i in range(len(self.spec.sa_levels)):
            new_xyz, new_feats = getattr(self, f"sa{i + 1}")(l_xyz[i], l_feats[i], None, bn_momentum)
            l_xyz.append(new_xyz)
            l_feats.append(new_feats)
        skip = [onehot, xyz] + ([features] if features is not None else [])
        if self.dtype is not None:
            skip = [t.to(self.dtype) for t in skip]
        l_feats[0] = torch.cat(skip, dim=-1)
        n = len(self.spec.sa_levels)
        for j in range(len(self.spec.fp_mlps)):
            lvl = n - 1 - j
            # known None at the group-all level: the global feature broadcast
            l_feats[lvl] = getattr(self, f"fp{lvl + 1}")(
                l_xyz[lvl], l_xyz[lvl + 1], l_feats[lvl], l_feats[lvl + 1], None, bn_momentum)
        h = self.head_fc(l_feats[0], None, bn_momentum)
        if self.training and self.spec.dropout > 0.0:
            h = _dropout(h, self.spec.dropout, generator)
        return self.head_out(h, None, bn_momentum).to(torch.float32)


def get_partseg_model(
    num_parts: int,
    num_categories: int,
    is_msg: bool = False,
    *,
    input_channels: int = 0,
    use_xyz: bool = True,
    bn: bool = True,
    dtype: torch.dtype | None = None,
    bn_group=None,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> PointNet2PartSeg:
    """The JAX get_partseg_model's arguments and defaults (SSG unless is_msg)."""
    return PointNet2PartSeg(
        num_parts, num_categories, partseg_msg_spec() if is_msg else partseg_ssg_spec(),
        input_channels=input_channels, use_xyz=use_xyz, bn=bn, dtype=dtype, bn_group=bn_group,
        device=device, generator=generator,
    )
