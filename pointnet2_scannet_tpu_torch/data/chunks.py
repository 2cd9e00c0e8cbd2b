"""Per-epoch chunk sampling and training-time augmentation (numpy only), the
JAX package's data/chunks.py with the same rng streams, so the same seed
gives the same chunks, augmentations and weights.

  - generate_chunks: per scene, up to chunk_retries draws of a 1.5 m x 1.5 m
    full-height column centred on a random point; a draw is valid when >= 70%
    of its points have label > 0 and >= 2% of a 31x31x62 voxelization is
    occupied; the last draw is kept even if invalid; then a resample with
    replacement to npoints. (`label > 0` counts class 0, floor, as
    unannotated: the reference's quirk, kept.)
  - augmentation: centre the chunk, then one of 8 equally likely cases of
    {translate U(-0.5, 0.5) m, rotate U(-5, 5) degrees per axis with pi taken
    as 3.14, scale U(0.95, 1.05)}, then un-centre.
  - per-point weights: the class weight of the point's label times an
    in-bbox mask that is always true (the bbox is the chunk's own).

The device-resident mode of the JAX package (resident=True) is ROADMAP
queue 1, item 13.
"""

from __future__ import annotations

import threading

import numpy as np

from pointnet2_scannet_tpu_torch.config import DataConfig
from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore, assemble_features
from pointnet2_scannet_tpu_torch.utils import native


def _rotation_matrix(rng: np.random.Generator, pi: float) -> np.ndarray:
    tx, ty, tz = rng.uniform(-5.0, 5.0, size=3) * pi / 180.0
    cx, sx = np.cos(tx), np.sin(tx)
    cy, sy = np.cos(ty), np.sin(ty)
    cz, sz = np.cos(tz), np.sin(tz)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def draw_augment_params(
    rng: np.random.Generator,
) -> tuple[np.ndarray | None, np.ndarray | None, float | None]:
    """One chunk's (rotation, translation, scale), None for a transform its
    case leaves out. Draw order: case, then t, then R's three angles, then s."""
    pi = 3.14  # the reference's value, kept
    case = rng.integers(0, 8)
    do_t = case in (1, 4, 5, 7)
    do_r = case in (2, 4, 6, 7)
    do_s = case in (3, 5, 6, 7)
    t = rng.uniform(-0.5, 0.5, size=3) if do_t else None
    rot = _rotation_matrix(rng, pi) if do_r else None
    s = float(rng.uniform(0.95, 1.05)) if do_s else None
    return rot, t, s


def augment_coords(coords: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Translate / rotate / scale chunk coordinates about their centroid."""
    center = coords.mean(axis=0)
    out = coords - center
    rot, t, s = draw_augment_params(rng)
    if t is not None:
        out = out + t
    if rot is not None:
        out = (rot @ out.T).T
    if s is not None:
        out = out * s
    return (out + center).astype(np.float32)


class ChunkedSceneDataset:
    """One training chunk per scene per epoch, resampled each epoch."""

    def __init__(self, store: SceneStore, cfg: DataConfig, *, phase: str = "train", seed: int = 0):
        if phase not in ("train", "val", "test"):
            raise ValueError(f"phase must be train, val or test, got {phase!r}")
        self.store = store
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        # a stream of its own for chunk generation, so the async regeneration
        # thread never races the main thread's augmentation draws
        self.chunk_rng = np.random.default_rng(seed + 0x5EED)
        # scene_id -> (chunk (npoints, 11), multiview (npoints, 128) | None)
        self.chunks: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        self._next: dict[str, tuple[np.ndarray, np.ndarray | None]] | None = None
        self._regen_thread: threading.Thread | None = None

    def __len__(self) -> int:
        return len(self.store)

    def generate_chunks(self) -> None:
        """Resample one chunk per scene; takes a pending async regeneration's
        result instead of recomputing."""
        if self._regen_thread is not None:
            self._regen_thread.join()
            self._regen_thread = None
            if self._next is not None:
                self.chunks = self._next
                self._next = None
                return
        self.chunks = self._generate()

    def start_regen_async(self) -> None:
        """Start the next epoch's chunk resampling on a background thread."""
        if self._regen_thread is not None:
            return

        def work():
            self._next = self._generate()

        self._regen_thread = threading.Thread(target=work, daemon=True)
        self._regen_thread.start()

    def _generate(self) -> dict:
        cfg = self.cfg
        out: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        half_xy = cfg.chunk_size_xy / 2.0
        for sid in self.store.scene_ids:
            scene = self.store.scenes[sid]
            semantic = scene[:, 10].astype(np.int32)
            mv = self.store.multiview.get(sid) if cfg.use_multiview else None
            coordmin = scene[:, :3].min(axis=0)
            coordmax = scene[:, :3].max(axis=0)
            xyz32 = np.ascontiguousarray(scene[:, :3], np.float32)
            cur = None
            for _ in range(cfg.chunk_retries):
                center = scene[self.chunk_rng.integers(len(scene)), :3]
                curmin = (center - [half_xy, half_xy, 1.5]).astype(np.float32)
                curmax = (center + [half_xy, half_xy, 1.5]).astype(np.float32)
                curmin[2], curmax[2] = coordmin[2], coordmax[2]
                inside, n_annotated, n_occupied = native.chunk_scan(
                    xyz32, semantic, curmin, curmax, cfg.chunk_margin
                )
                cur = (scene[inside], mv[inside] if mv is not None else None)
                n_inside = len(cur[0])
                if n_inside == 0:
                    continue
                annotated = n_annotated / n_inside
                occupancy = n_occupied / (31.0 * 31.0 * 62.0)
                if annotated >= cfg.min_annotated_frac and occupancy >= cfg.min_voxel_occupancy:
                    break
            chunk, chunk_mv = cur
            choice = self.chunk_rng.integers(0, len(chunk), size=cfg.npoints)
            out[sid] = (chunk[choice], chunk_mv[choice] if chunk_mv is not None else None)
        return out

    def get_item(self, index: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(features (npoints, 3 + C) float32, labels (npoints,) int32,
        weights (npoints,) float32)."""
        sid = self.store.scene_ids[index]
        if sid not in self.chunks:
            raise RuntimeError("call generate_chunks() before sampling items")
        chunk, mv = self.chunks[sid]
        cfg = self.cfg
        feats = assemble_features(
            chunk, mv, use_color=cfg.use_color, use_normal=cfg.use_normal,
            use_multiview=cfg.use_multiview,
        )
        if self.phase == "train" and cfg.augment:
            feats[:, :3] = augment_coords(feats[:, :3], self.rng)
        labels = chunk[:, 10].astype(np.int32)
        lo = feats[:, :3].min(axis=0) - 0.01
        hi = feats[:, :3].max(axis=0) + 0.01
        mask = np.all((feats[:, :3] >= lo) & (feats[:, :3] <= hi), axis=1)
        weights = (self.store.label_weights[labels] * mask).astype(np.float32)
        return feats, labels, weights
