"""In-memory scene store and feature assembly (numpy only).

Preprocessed scenes are (N, 11) float arrays laid out as
[xyz, rgb(0-255), normal, instance_label, semantic_label], with an optional
(N, 128) multiview bank per scene; features are assembled in the canonical
order [xyz, color/255, normal, multiview], as in the JAX package. A
data-parallel run loads each rank's scene shard (from_npy_dir_sharded,
shard) with the class weights of the whole split.
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


def weights_from_counts(counts: np.ndarray) -> np.ndarray:
    """Inverse-log-frequency class weights 1/log(1.2 + freq) of a label
    histogram."""
    freq = counts.astype(np.float32) / max(counts.sum(), 1.0)
    return (1.0 / np.log(1.2 + freq)).astype(np.float32)


def compute_label_weights(labels_per_scene, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Inverse-log-frequency class weights 1/log(1.2 + freq) over a split."""
    return weights_from_counts(label_counts(labels_per_scene, num_classes))


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
    def from_npy_dir_sharded(
        cls,
        scene_ids: Sequence[str],
        preprocessed_dir: str | pathlib.Path,
        multiview_h5: str | pathlib.Path | None = None,
        *,
        process_id: int,
        num_processes: int,
        num_classes: int = NUM_CLASSES,
        is_weighting: bool = True,
        equalize: bool = True,
        ctx=None,
    ) -> "SceneStore":
        """Rank process_id's strided scene shard (SceneStore.shard's), loaded
        alone, with the class weights of the WHOLE split: were each rank to
        weigh by its shard, the ranks would train on different losses.

        With ctx (a parallel.ProcessContext; every rank calls this, one
        collective) each rank counts the labels it loaded, the first dp rank
        adds the scenes that equalize dropped, and the counts are summed
        over the dp ranks in float64 (process_id and num_processes are then
        ctx's dp index and dp ranks: the tp ranks of a dp index load the
        same shard). Without it, one streaming pass over every
        scene's label column (memory-mapped, one scene at a time)."""
        from pointnet2_scannet_tpu_torch.parallel.distributed import strided_shard

        root = pathlib.Path(preprocessed_dir)
        my_ids = strided_shard(scene_ids, process_id, num_processes, equalize=equalize)
        store = cls.from_npy_dir(my_ids, preprocessed_dir, multiview_h5, num_classes=num_classes,
                                 is_weighting=False)
        if not is_weighting:
            return store
        if ctx is not None and ctx.dp > 1:
            if (ctx.dp_index, ctx.dp) != (process_id, num_processes):
                raise ValueError(f"ctx is dp rank {ctx.dp_index} of {ctx.dp}, not "
                                 f"{process_id} of {num_processes}")
            counts = label_counts((store.scenes[sid][:, 10] for sid in my_ids), num_classes)
            covered = len(scene_ids) // num_processes * num_processes if equalize else len(scene_ids)
            if ctx.dp_index == 0 and covered < len(scene_ids):
                counts += label_counts((np.load(root / f"{sid}.npy", mmap_mode="r")[:, 10]
                                        for sid in list(scene_ids)[covered:]), num_classes)
            store.label_weights = weights_from_counts(ctx.sum_across_processes(counts))
        else:
            store.label_weights = compute_label_weights(
                (np.load(root / f"{sid}.npy", mmap_mode="r")[:, 10] for sid in scene_ids), num_classes)
        return store

    @classmethod
    def from_scenes(cls, scenes: dict[str, np.ndarray], **kwargs) -> "SceneStore":
        return cls(sorted(scenes), scenes, **kwargs)

    def shard(self, process_id: int, num_processes: int, *, equalize: bool = True) -> "SceneStore":
        """Rank process_id's strided scene shard (parallel.strided_shard:
        equalize for training, where every rank needs the same steps an
        epoch; not for evaluation, which covers every scene). The class
        weights stay the whole split's."""
        from pointnet2_scannet_tpu_torch.parallel.distributed import strided_shard

        if num_processes <= 1:
            return self
        ids = strided_shard(self.scene_ids, process_id, num_processes, equalize=equalize)
        sub = SceneStore.__new__(SceneStore)
        sub.scene_ids = ids
        sub.scenes = {sid: self.scenes[sid] for sid in ids}
        sub.multiview = {sid: self.multiview[sid] for sid in ids if sid in self.multiview}
        sub.num_classes = self.num_classes
        sub.label_weights = self.label_weights
        return sub

    def __len__(self) -> int:
        return len(self.scene_ids)
