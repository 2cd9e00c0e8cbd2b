"""The SSG segmentation model of the port and its building blocks."""

from pointnet2_scannet_tpu_torch.models.convert import state_dict_from_jax
from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP
from pointnet2_scannet_tpu_torch.models.modules import FeaturePropagation, SetAbstraction
from pointnet2_scannet_tpu_torch.models.pointnet2 import (
    PointNet2SemSeg,
    PointNet2Spec,
    get_model,
    ssg_spec,
)

__all__ = [
    "PointwiseMLP",
    "SetAbstraction",
    "FeaturePropagation",
    "PointNet2Spec",
    "PointNet2SemSeg",
    "ssg_spec",
    "get_model",
    "state_dict_from_jax",
]
