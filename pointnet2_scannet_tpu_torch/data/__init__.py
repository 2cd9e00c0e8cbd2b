"""Host-side data of the serving path: scene store, synthetic scenes and the
whole-scene column tiler (numpy only)."""

from pointnet2_scannet_tpu_torch.data.scene_store import (
    SceneStore,
    assemble_features,
    compute_label_weights,
)
from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene, make_synthetic_store
from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset

__all__ = [
    "SceneStore",
    "assemble_features",
    "compute_label_weights",
    "make_synthetic_scene",
    "make_synthetic_store",
    "WholeSceneDataset",
]
