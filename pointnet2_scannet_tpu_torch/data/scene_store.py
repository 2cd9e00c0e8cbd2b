"""In-memory scene store and feature assembly (numpy only).

Preprocessed scenes are (N, 11) float arrays laid out as
[xyz, rgb(0-255), normal, instance_label, semantic_label], with an optional
(N, 128) multiview bank per scene; features are assembled in the canonical
order [xyz, color/255, normal, multiview], as in the JAX package.
"""

from __future__ import annotations

import pathlib
from collections.abc import Sequence

import numpy as np

from pointnet2_scannet_tpu_torch.config import NUM_CLASSES


def label_counts(labels_per_scene, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Per-class label histogram over an iterable of per-scene label arrays."""
    counts = np.zeros(num_classes, np.float64)
    for seg in labels_per_scene:
        tmp, _ = np.histogram(seg, bins=range(num_classes + 1))
        counts += tmp
    return counts


def compute_label_weights(labels_per_scene, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Inverse-log-frequency class weights 1/log(1.2 + freq) over a split."""
    counts = label_counts(labels_per_scene, num_classes)
    freq = counts.astype(np.float32) / max(counts.sum(), 1.0)
    return (1.0 / np.log(1.2 + freq)).astype(np.float32)


def assemble_features(
    scene: np.ndarray,
    multiview: np.ndarray | None,
    *,
    use_color: bool,
    use_normal: bool,
    use_multiview: bool,
) -> np.ndarray:
    """The (N, 3 + C) input columns [xyz, color/255, normal, multiview]."""
    cols = [scene[:, :3]]
    if use_color:
        cols.append(scene[:, 3:6] / 255.0)
    if use_normal:
        cols.append(scene[:, 6:9])
    if use_multiview:
        if multiview is None:
            raise ValueError("use_multiview=True but no multiview features given")
        cols.append(multiview)
    return np.concatenate(cols, axis=1).astype(np.float32)


class SceneStore:
    """All scenes of a split held in RAM, with the split's class weights."""

    def __init__(
        self,
        scene_ids: Sequence[str],
        scenes: dict[str, np.ndarray],
        multiview: dict[str, np.ndarray] | None = None,
        num_classes: int = NUM_CLASSES,
        is_weighting: bool = True,
    ):
        self.scene_ids = list(scene_ids)
        self.scenes = scenes
        self.multiview = multiview or {}
        self.num_classes = num_classes
        if is_weighting:
            self.label_weights = compute_label_weights(
                [scenes[sid][:, 10] for sid in self.scene_ids], num_classes
            )
        else:
            self.label_weights = np.ones(num_classes, np.float32)

    @classmethod
    def from_npy_dir(
        cls,
        scene_ids: Sequence[str],
        preprocessed_dir: str | pathlib.Path,
        multiview_h5: str | pathlib.Path | None = None,
        **kwargs,
    ) -> "SceneStore":
        """Load `<dir>/<scene_id>.npy` files (+ an optional multiview HDF5)."""
        root = pathlib.Path(preprocessed_dir)
        scenes = {sid: np.load(root / f"{sid}.npy") for sid in scene_ids}
        multiview = None
        if multiview_h5 is not None:
            import h5py

            with h5py.File(multiview_h5, "r") as f:
                multiview = {sid: f[sid][()] for sid in scene_ids}
        return cls(scene_ids, scenes, multiview, **kwargs)

    @classmethod
    def from_scenes(cls, scenes: dict[str, np.ndarray], **kwargs) -> "SceneStore":
        return cls(sorted(scenes), scenes, **kwargs)

    def __len__(self) -> int:
        return len(self.scene_ids)
