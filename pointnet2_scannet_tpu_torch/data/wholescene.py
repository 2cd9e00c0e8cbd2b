"""Whole-scene tiling into full-height columns, for inference and for
whole-scene training (numpy only).

The JAX package's data/wholescene.py: tile the scene's xy bounding box into
chunk_size_xy squares (with a +-0.01 m border overlap), skip empty columns,
and draw `npoints` indices per column with replacement from a per-scene
stream seeded by (seed, epoch, crc32(scene id)). The same store, seed and
epoch give bit-identical column stacks in both packages.
"""

from __future__ import annotations

import zlib

import numpy as np

from pointnet2_scannet_tpu_torch.config import DataConfig
from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore, assemble_features
from pointnet2_scannet_tpu_torch.utils import native


class WholeSceneDataset:
    """Per scene: (S, npoints, 3 + C) feature stack, labels and weights."""

    def __init__(self, store: SceneStore, cfg: DataConfig, *, seed: int = 0):
        self.store = store
        self.cfg = cfg
        self.seed = seed
        # inference and validation keep epoch 0, so their tilings stay fixed;
        # whole-scene training moves it every epoch (set_epoch) to redraw
        # every column's resampling
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.store)

    @property
    def input_channels(self) -> int:
        return self.cfg.input_channels

    def max_points(self) -> int:
        """Largest point count of a scene (the evaluator's ring slot rows)."""
        return max(len(self.store.scenes[sid]) for sid in self.store.scene_ids)

    def estimate_columns(self) -> list[int]:
        """Per scene, an upper bound on its non-empty columns (nx * ny from
        the xy bounds, no tiling pass): the evaluator sizes its ring by it."""
        out = []
        L = self.cfg.chunk_size_xy
        for sid in self.store.scene_ids:
            xyz = self.store.scenes[sid][:, :3]
            lo, hi = xyz.min(axis=0), xyz.max(axis=0)
            nx = max(int(np.ceil((hi[0] - lo[0]) / L)), 1)
            ny = max(int(np.ceil((hi[1] - lo[1]) / L)), 1)
            out.append(nx * ny)
        return out

    def _tile_indices(self, index: int):
        """(feats_all (N, 3 + C) f32, sel (S, npoints) int64): the resample
        indices of every non-empty column."""
        cfg = self.cfg
        sid = self.store.scene_ids[index]
        scene = self.store.scenes[sid]
        mv = self.store.multiview.get(sid) if cfg.use_multiview else None
        feats_all = assemble_features(
            scene, mv,
            use_color=cfg.use_color,
            use_normal=cfg.use_normal,
            use_multiview=cfg.use_multiview,
        )
        coordmin = feats_all[:, :3].min(axis=0)
        coordmax = feats_all[:, :3].max(axis=0)
        L = cfg.chunk_size_xy
        nx = max(int(np.ceil((coordmax[0] - coordmin[0]) / L)), 1)
        ny = max(int(np.ceil((coordmax[1] - coordmin[1]) / L)), 1)
        counts, members = native.tile_columns(
            feats_all[:, :3],
            coordmin,
            float(np.float32(coordmax[2] - coordmin[2])),
            float(L),
            0.01,
            nx,
            ny,
        )
        counts_flat = counts.reshape(-1)
        offsets = np.concatenate([[0], np.cumsum(counts_flat)])
        rng = np.random.default_rng((self.seed, self.epoch, zlib.crc32(sid.encode())))
        sels = []
        for col in range(nx * ny):
            cnt = counts_flat[col]
            if cnt == 0:
                continue
            idx = members[offsets[col] : offsets[col] + cnt]
            choice = rng.integers(0, cnt, size=cfg.npoints)
            sels.append(idx[choice])
        return feats_all, np.stack(sels)

    def get_scene(self, index: int):
        """feats (S, npoints, 3 + C) f32, labels (S, npoints) int32,
        weights (S, npoints) f32 — S = number of non-empty columns."""
        feats_all, col_idx, labels, weights = self.get_scene_indexed(index)
        return feats_all[col_idx], labels, weights

    def get_scene_indexed(self, index: int):
        """The scene without per-column copies: feats_all (N, 3 + C) f32,
        col_idx (S, npoints) int32, labels (S, npoints) int32, weights (S,
        npoints) f32. The same draws as get_scene, so feats_all[col_idx]
        equals get_scene(index)[0]."""
        sid = self.store.scene_ids[index]
        feats_all, sel = self._tile_indices(index)
        lab = self.store.scenes[sid][:, 10].astype(np.int32)[sel]
        return (
            feats_all.astype(np.float32, copy=False),
            sel.astype(np.int32),
            lab,
            self.store.label_weights[lab].astype(np.float32),
        )

    def iter_scenes(self):
        for i in range(len(self)):
            yield self.store.scene_ids[i], self.get_scene(i)

    def iter_scenes_indexed(self):
        for i in range(len(self)):
            yield self.store.scene_ids[i], self.get_scene_indexed(i)
