"""Device-resident scene store: the Solver's device_store (the JAX package's
data/resident.py).

On the host path every train step assembles its batch on the host (B x
npoints x (3 + C) float32, with augmentation) and copies it to the card. With
the store:

  - every scene's features and labels are assembled once and uploaded once
    into a flat (T, 3 + C) float32 / (T,) int32 store on the card
    (flatten_store);
  - each epoch's chunk regeneration keeps scene rows, not points
    (ChunkedSceneDataset(resident=True));
  - a step sends the card (B, npoints) int32 store rows and, when the
    dataset augments, each chunk's rotation, translation and scale
    (ResidentBatchLoader);
  - on the card, materialize_batch gathers the rows from the store with the
    row gather (gather_rows: csrc/gather.cu on a CUDA tensor, its plain
    version on the CPU), applies the augmentation and looks the class
    weights up.

Semantics are the host path's: the same rng streams, batches equal bit for
bit with augmentation off, and coordinates equal to float32 rounding with it
on (the host applies the rotation in float64 numpy, the card in float32).
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import DataConfig
from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore, assemble_features
from pointnet2_scannet_tpu_torch.ops.sampling import gather_rows


def store_nbytes(store: SceneStore, cfg: DataConfig) -> int:
    """Bytes of the flat store on the device (features float32, labels int32)."""
    total = sum(len(store.scenes[sid]) for sid in store.scene_ids)
    return total * ((3 + cfg.input_channels) * 4 + 4)


def flatten_store(store: SceneStore, cfg: DataConfig) -> tuple[np.ndarray, np.ndarray]:
    """Every scene assembled and concatenated in scene_ids order: (points
    (T, 3 + C) float32, labels (T,) int32), in the row space of
    ChunkedSceneDataset.scene_offsets()."""
    counts = [len(store.scenes[sid]) for sid in store.scene_ids]
    total = sum(counts)
    if total >= 2**31:
        # the batches' store rows are int32: past 2^31 they would wrap
        raise ValueError(
            f"flattened store has {total} rows >= 2^31; int32 descriptor "
            "indices would overflow — device_store cannot hold this dataset"
        )
    pts = np.empty((total, 3 + cfg.input_channels), np.float32)
    labels = np.empty(total, np.int32)
    o = 0
    for sid, n in zip(store.scene_ids, counts):
        scene = store.scenes[sid]
        mv = store.multiview.get(sid) if cfg.use_multiview else None
        pts[o : o + n] = assemble_features(
            scene, mv, use_color=cfg.use_color, use_normal=cfg.use_normal,
            use_multiview=cfg.use_multiview,
        )
        labels[o : o + n] = scene[:, 10].astype(np.int32)
        o += n
    return pts, labels


class ResidentBatchLoader:
    """Resident-mode train batches: {"idx" (B, npoints) int32 global store
    rows, "row_mask" (B,) float32, and, only when the dataset augments,
    "rot" (B, 3, 3), "trans" (B, 3), "scale" (B,) float32}. Without the
    augmentation keys materialize_batch skips the transform, so the
    coordinates stay the host path's bits.

    Full batches only (BatchLoader's drop_last, as the Solver's train
    loader); the scene order, shuffled or not, is BatchLoader's at the same
    seed."""

    def __init__(self, dataset: ChunkedSceneDataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0):
        if not dataset.resident:
            raise ValueError("ResidentBatchLoader needs a resident-mode dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_full = len(order) // self.batch_size * self.batch_size
        for start in range(0, n_full, self.batch_size):
            items = [self.dataset.get_item_resident(int(i))
                     for i in order[start : start + self.batch_size]]
            idx, rot, trans, scale = (np.stack(c) for c in zip(*items))
            batch = {"idx": idx, "row_mask": np.ones(self.batch_size, np.float32)}
            if self.dataset.augmenting:
                batch.update(rot=rot, trans=trans, scale=scale)
            yield batch


def _finish_batch(store: dict, batch: dict, pts: torch.Tensor, labels: torch.Tensor) -> dict:
    """The augmentation, where its parameters ride along, in
    chunks.augment_coords' order (centre, + t, rotate, x s, uncentre), in
    float32; and the class weights, wtable[labels] (the host path's in-bbox
    mask is always 1)."""
    if "rot" in batch:
        xyz = pts[..., :3]
        center = xyz.mean(dim=1, keepdim=True)
        out = xyz - center + batch["trans"][:, None, :]
        # out @ R^T per sample: the host's (R @ out.T).T
        out = torch.einsum("bnc,bdc->bnd", out, batch["rot"])
        out = out * batch["scale"][:, None, None] + center
        pts = torch.cat([out, pts[..., 3:]], dim=-1)
    return {
        "points": pts,
        "labels": labels,
        "weights": store["wtable"][labels.long()],
        "row_mask": batch["row_mask"],
    }


def materialize_batch(store: dict, batch: dict) -> dict:
    """A train batch of "points", "labels", "weights" and "row_mask" on the
    store's device, from a resident batch there: two row gathers out of the
    store (points, labels; gather_rows on a (1, T, C) view), then
    _finish_batch.

    store: {"points" (T, 3 + C) float32, "labels" (T,) int32, "wtable" (K,)
    float32}."""
    idx = batch["idx"]
    b, n = idx.shape
    rows = idx.reshape(1, b * n)
    pts = gather_rows(store["points"].unsqueeze(0), rows).view(b, n, -1)
    labels = gather_rows(store["labels"].view(1, -1, 1), rows).view(b, n)
    return _finish_batch(store, batch, pts, labels)


def pad_store_rows(pts: np.ndarray, labels: np.ndarray, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero rows appended to the flat store up to a multiple of n_shards (a
    row-sharded store splits its rows evenly; batches name only real rows)."""
    pad = -pts.shape[0] % n_shards
    if pad:
        pts = np.concatenate([pts, np.zeros((pad,) + pts.shape[1:], pts.dtype)])
        labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
    return pts, labels
