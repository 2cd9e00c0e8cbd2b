"""The SSG and MSG segmentation models of the port, the shape families
(classification, part segmentation), their building blocks and the votenet
modules."""

from pointnet2_scannet_tpu_torch.models.convert import state_dict_from_jax
from pointnet2_scannet_tpu_torch.models.layers import FC, BNMomentumScheduler, PointwiseMLP, RandomDropout
from pointnet2_scannet_tpu_torch.models.modules import (
    FeaturePropagation,
    LearnableFeaturePropagationMSG,
    SetAbstraction,
    SetAbstractionMSGVotes,
    SetAbstractionVotes,
)
from pointnet2_scannet_tpu_torch.models.pointnet2 import (
    PointNet2SemSeg,
    PointNet2Spec,
    get_model,
    model_from_config,
    msg_spec,
    ssg_spec,
)
from pointnet2_scannet_tpu_torch.models.pointnet2_cls import (
    PointNet2Cls,
    PointNet2ClsSpec,
    cls_msg_spec,
    cls_ssg_spec,
    get_cls_model,
)
from pointnet2_scannet_tpu_torch.models.pointnet2_partseg import (
    PointNet2PartSeg,
    PointNet2PartSegSpec,
    get_partseg_model,
    partseg_msg_spec,
    partseg_ssg_spec,
)

__all__ = [
    "FC",
    "BNMomentumScheduler",
    "PointwiseMLP",
    "RandomDropout",
    "SetAbstraction",
    "SetAbstractionVotes",
    "SetAbstractionMSGVotes",
    "LearnableFeaturePropagationMSG",
    "FeaturePropagation",
    "PointNet2Spec",
    "PointNet2SemSeg",
    "ssg_spec",
    "msg_spec",
    "get_model",
    "model_from_config",
    "PointNet2ClsSpec",
    "PointNet2Cls",
    "cls_ssg_spec",
    "cls_msg_spec",
    "get_cls_model",
    "PointNet2PartSegSpec",
    "PointNet2PartSeg",
    "partseg_ssg_spec",
    "partseg_msg_spec",
    "get_partseg_model",
    "state_dict_from_jax",
]
