"""The SSG and MSG segmentation models of the port and their building blocks."""

from pointnet2_scannet_tpu_torch.models.convert import state_dict_from_jax
from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP
from pointnet2_scannet_tpu_torch.models.modules import FeaturePropagation, SetAbstraction
from pointnet2_scannet_tpu_torch.models.pointnet2 import (
    PointNet2SemSeg,
    PointNet2Spec,
    get_model,
    model_from_config,
    msg_spec,
    ssg_spec,
)

__all__ = [
    "PointwiseMLP",
    "SetAbstraction",
    "FeaturePropagation",
    "PointNet2Spec",
    "PointNet2SemSeg",
    "ssg_spec",
    "msg_spec",
    "get_model",
    "model_from_config",
    "state_dict_from_jax",
]
