"""Synthetic rooms, the chunk draw and the whole-scene tiling, frozen here so
that a change to the program cannot move the traffic (numpy only).

Copies, with the sources they were taken from:

- fast_scene: bench_torch.fast_scene's room (a floor plane and 12 boxes
  with class-correlated colours), with the side as a parameter where the
  original fixes 8 m, drawn in float32,
  with uniform colour noise of the original's deviation and without the
  final shuffle: a third of the set-up time.
- label_weights: data/scene_store.weights_from_counts over a label
  histogram, 1 / log(1.2 + freq).
- ChunkSampler.draw: data/chunks.ChunkedSceneDataset._generate for one scene, with
  the crop-and-validity scan of utils/native.chunk_scan's numpy form: up to
  `retries` draws of a 1.5 m full-height column around a random point, a
  draw valid when >= 70% of its points have label > 0 and >= 2% of a
  31 x 31 x 62 grid is occupied, the last draw kept; then a resample with
  replacement to npoints.
- augment_coords: data/chunks.augment_coords (centre; one of 8 cases of
  translate, rotate with pi as 3.14, scale; un-centre).
"""

from __future__ import annotations

import numpy as np

CHUNK_XY = 1.5
CHUNK_MARGIN = 0.2
MIN_ANNOTATED = 0.7
MIN_OCCUPANCY = 0.02


def fast_scene(rng: np.random.Generator, n_points: int, side: float = 8.0) -> np.ndarray:
    """A synthetic room in the (N, 11) preprocessed layout [xyz, rgb 0-255,
    normal, instance, label]: a floor plane of side `side` (a third of the
    points, label 0) and 12 furniture boxes (labels 2-19) with
    class-correlated colours."""
    f32 = np.float32
    n_floor = n_points // 3
    n_obj = 12
    scene = np.zeros((n_points, 11), f32)
    scene[:n_floor, :2] = rng.random((n_floor, 2), f32) * f32(side)
    scene[:n_floor, 2] = rng.standard_normal(n_floor, f32) * f32(0.01)
    centers = (rng.uniform(0.5, side - 0.5, (n_obj, 3)) * [1, 1, 0.2 * 8.0 / side]).astype(f32)
    obj_of = rng.integers(0, n_obj, n_points - n_floor)
    scene[n_floor:, :3] = centers[obj_of] + (rng.random((n_points - n_floor, 3), f32) - f32(0.5))
    scene[n_floor:, 9] = obj_of + 1
    labels = np.zeros(n_points, np.int64)
    labels[n_floor:] = (obj_of * 7) % 18 + 2
    scene[:, 10] = labels
    tint = (np.arange(20, dtype=f32)[:, None] * np.array([53.0, 101.0, 181.0], f32)) % 256
    colors = rng.random((n_points, 3), f32)  # noise uniform in +-14, standard deviation 8
    colors *= f32(28.0)
    colors += tint[labels] - f32(14.0)
    scene[:, 3:6] = np.clip(colors, 0, 255, out=colors)
    scene[:, 8] = 1.0
    return scene


def features(scene: np.ndarray) -> np.ndarray:
    """The (N, 9) input columns [xyz, colour / 255, normal]."""
    return np.concatenate([scene[:, :3], scene[:, 3:6] / 255.0, scene[:, 6:9]], axis=1).astype(np.float32)


def label_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Inverse-log-frequency class weights 1 / log(1.2 + freq)."""
    counts = np.bincount(labels.reshape(-1).astype(np.int64), minlength=num_classes)[:num_classes]
    freq = counts.astype(np.float32) / max(counts.sum(), 1.0)
    return (1.0 / np.log(1.2 + freq)).astype(np.float32)


class ChunkSampler:
    """One scene's chunk draws. The scene's points are bucketed by x (a
    stable radix sort of 16-bit bucket numbers) so a crop scans only the
    buckets around its x-range; the rows it returns are in the scene's own
    order, as the full scan gives them."""

    BUCKETS = 256

    def __init__(self, scene: np.ndarray):
        self.scene = scene
        self.xyz = np.ascontiguousarray(scene[:, :3], np.float32)
        self.labels = scene[:, 10]
        self.x, self.y = self.xyz[:, 0].copy(), self.xyz[:, 1].copy()
        x = self.x.astype(np.float64)
        self.x0, self.width = x.min(), max(x.max() - x.min(), 1e-6) / self.BUCKETS
        bucket = np.minimum(((x - self.x0) / self.width).astype(np.int16), self.BUCKETS - 1)
        self.order = np.argsort(bucket, kind="stable")
        self.starts = np.searchsorted(bucket[self.order], np.arange(self.BUCKETS + 1))
        self.zmin = self.xyz[:, 2].min()
        self.zmax = self.xyz[:, 2].max()

    def _bucket(self, x: float) -> int:
        return int(np.clip(np.floor((x - self.x0) / self.width), 0, self.BUCKETS - 1))

    def _scan(self, lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, int, int]:
        """utils/native.chunk_scan's numpy form on this scene: (rows inside
        [lo - margin, hi + margin] ascending, count with label > 0, occupied
        cells)."""
        a = self.starts[max(self._bucket(float(lo[0]) - CHUNK_MARGIN) - 1, 0)]
        b = self.starts[min(self._bucket(float(hi[0]) + CHUNK_MARGIN) + 2, self.BUCKETS)]
        cand = self.order[a:b]
        lo_m, hi_m = lo - CHUNK_MARGIN, hi + CHUNK_MARGIN
        x, y = self.x[cand], self.y[cand]
        # z spans the scene's own range, which every point is inside
        inside = (x >= lo_m[0]) & (x <= hi_m[0]) & (y >= lo_m[1]) & (y <= hi_m[1])
        rows = np.sort(cand[inside])
        sel = self.xyz[rows]
        annotated = int(np.sum(self.labels[rows] > 0))
        tight = np.all((sel >= lo - 0.01) & (sel <= hi + 0.01), axis=1)
        extent = hi - lo
        if (extent <= 0).any() or not tight.any():
            return rows, annotated, 0
        v = np.ceil((sel[tight] - lo) / extent * [31.0, 31.0, 62.0]).astype(np.int64)
        return rows, annotated, len(np.unique(v[:, 0] * 31 * 62 + v[:, 1] * 62 + v[:, 2]))

    def draw(self, rng: np.random.Generator, npoints: int, retries: int) -> np.ndarray:
        """One chunk (npoints, 11), resampled with replacement."""
        half = CHUNK_XY / 2.0
        rows = None
        for _ in range(retries):
            center = self.xyz[rng.integers(len(self.xyz))]
            lo = (center - [half, half, 1.5]).astype(np.float32)
            hi = (center + [half, half, 1.5]).astype(np.float32)
            lo[2], hi[2] = self.zmin, self.zmax
            got, annotated, occupied = self._scan(lo, hi)
            if len(got) == 0:
                continue
            rows = got
            if annotated / len(got) >= MIN_ANNOTATED and occupied / (31.0 * 31.0 * 62.0) >= MIN_OCCUPANCY:
                break
        return self.scene[rows[rng.integers(0, len(rows), size=npoints)]]


def _rotation_matrix(rng: np.random.Generator, pi: float) -> np.ndarray:
    tx, ty, tz = rng.uniform(-5.0, 5.0, size=3) * pi / 180.0
    cx, sx = np.cos(tx), np.sin(tx)
    cy, sy = np.cos(ty), np.sin(ty)
    cz, sz = np.cos(tz), np.sin(tz)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def augment_coords(coords: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Translate / rotate / scale chunk coordinates about their centroid:
    draw order case, t, the rotation's three angles, s."""
    center = coords.mean(axis=0)
    out = coords - center
    case = rng.integers(0, 8)
    if case in (1, 4, 5, 7):
        out = out + rng.uniform(-0.5, 0.5, size=3)
    if case in (2, 4, 6, 7):
        out = (_rotation_matrix(rng, 3.14) @ out.T).T
    if case in (3, 5, 6, 7):
        out = out * float(rng.uniform(0.95, 1.05))
    return (out + center).astype(np.float32)

