"""Host-side data: scene store, synthetic scenes, the whole-scene column
tiler (numpy only), and the device-resident scene store (data/resident.py)."""

from pointnet2_scannet_tpu_torch.data.resident import (
    ResidentBatchLoader,
    flatten_store,
    materialize_batch,
    pad_store_rows,
    store_nbytes,
)
from pointnet2_scannet_tpu_torch.data.scene_store import (
    SceneStore,
    assemble_features,
    compute_label_weights,
)
from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene, make_synthetic_store
from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset

__all__ = [
    "ResidentBatchLoader",
    "flatten_store",
    "materialize_batch",
    "pad_store_rows",
    "store_nbytes",
    "SceneStore",
    "assemble_features",
    "compute_label_weights",
    "make_synthetic_scene",
    "make_synthetic_store",
    "WholeSceneDataset",
]
