"""Synthetic shape-classification dataset (companion to models/pointnet2_cls),
the port's copy of the JAX package's data/shapes.py: the same samplers draw
the same arrays from the same np.random.Generator, bit for bit (numpy only).

BEYOND-REFERENCE: ero1311/Pointnet2.ScanNet has no classification data path;
this supplies the training/eval data for the PointNet2Cls family the way
data/synthetic.py supplies ScanNet-like scenes for the segmentation models —
parametric surface samplers with enough geometric signal that a classifier
trained on them demonstrably learns (used by scripts/train_cls_torch.py,
train_partseg_torch.py and eval_shapes_torch.py).

Each class is a distinct parametric surface sampled uniformly-ish at N
points; augmentation follows the standard PointNet++ classification recipe:
random z-rotation, anisotropic scale, Gaussian jitter, random translation.
Clouds are centered away from the origin so the FPS near-origin skip
(ops/sampling.py, the reference checkpoints' quirk) never eats surface
points.
"""

from __future__ import annotations

import numpy as np

SHAPE_CLASSES = (
    "sphere",
    "cube",
    "cylinder",
    "cone",
    "torus",
    "plane",
    "pyramid",
    "octahedron",
)


def _sphere(rng: np.random.Generator, n: int) -> np.ndarray:
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def _cube(rng: np.random.Generator, n: int) -> np.ndarray:
    p = rng.uniform(-1, 1, (n, 3))
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    np.put_along_axis(p, ax[:, None], sign[:, None], axis=-1)
    return p


def _cylinder(rng: np.random.Generator, n: int) -> np.ndarray:
    # lateral area 2*pi*r*h vs two caps 2*pi*r^2 with r=1, h=2: split 2:1
    n_side = (2 * n) // 3
    theta = rng.uniform(0, 2 * np.pi, n_side)
    side = np.column_stack(
        [np.cos(theta), np.sin(theta), rng.uniform(-1, 1, n_side)]
    )
    m = n - n_side
    r = np.sqrt(rng.uniform(0, 1, m))
    phi = rng.uniform(0, 2 * np.pi, m)
    caps = np.column_stack(
        [r * np.cos(phi), r * np.sin(phi), rng.choice([-1.0, 1.0], m)]
    )
    return np.concatenate([side, caps])


def _cone(rng: np.random.Generator, n: int) -> np.ndarray:
    # apex at z=1, unit base at z=-1; lateral surface + base disk
    n_side = (3 * n) // 4
    # uniform over the lateral surface: radius density ~ r
    r = np.sqrt(rng.uniform(0, 1, n_side))
    phi = rng.uniform(0, 2 * np.pi, n_side)
    side = np.column_stack([r * np.cos(phi), r * np.sin(phi), 1.0 - 2.0 * r])
    m = n - n_side
    rb = np.sqrt(rng.uniform(0, 1, m))
    pb = rng.uniform(0, 2 * np.pi, m)
    base = np.column_stack([rb * np.cos(pb), rb * np.sin(pb), np.full(m, -1.0)])
    return np.concatenate([side, base])


def _torus(rng: np.random.Generator, n: int) -> np.ndarray:
    # R=1, r=0.35; rejection-sample the minor angle for uniform area
    u = rng.uniform(0, 2 * np.pi, 2 * n)
    keep = rng.uniform(0, 1, 2 * n) < (1 + 0.35 * np.cos(u)) / 1.35
    u = np.resize(u[keep], n)
    v = rng.uniform(0, 2 * np.pi, n)
    ring = 1.0 + 0.35 * np.cos(u)
    return np.column_stack(
        [ring * np.cos(v), ring * np.sin(v), 0.35 * np.sin(u)]
    )


def _plane(rng: np.random.Generator, n: int) -> np.ndarray:
    p = rng.uniform(-1, 1, (n, 3))
    p[:, 2] = rng.normal(0, 0.01, n)
    return p


def _pyramid(rng: np.random.Generator, n: int) -> np.ndarray:
    # square base [-1,1]^2 at z=-0.6, apex (0,0,1); base + 4 triangle faces
    n_base = n // 3
    base = np.column_stack(
        [rng.uniform(-1, 1, n_base), rng.uniform(-1, 1, n_base), np.full(n_base, -0.6)]
    )
    m = n - n_base
    # sample triangles: pick a face, then barycentric over (apex, c0, c1)
    corners = np.array(
        [[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float64
    )
    f = rng.integers(0, 4, m)
    c0, c1 = corners[f], corners[(f + 1) % 4]
    a = rng.uniform(0, 1, m)
    b = rng.uniform(0, 1, m)
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    w_apex = 1 - a - b
    xy = a[:, None] * c0 + b[:, None] * c1
    z = w_apex * 1.0 + (a + b) * (-0.6)
    faces = np.column_stack([xy, z])
    return np.concatenate([base, faces])


def _octahedron(rng: np.random.Generator, n: int) -> np.ndarray:
    # |x|+|y|+|z| = 1: sample a simplex face, then random octant signs
    e = rng.exponential(size=(n, 3))
    p = e / e.sum(axis=1, keepdims=True)
    return p * rng.choice([-1.0, 1.0], (n, 3))


_SAMPLERS = {
    "sphere": _sphere,
    "cube": _cube,
    "cylinder": _cylinder,
    "cone": _cone,
    "torus": _torus,
    "plane": _plane,
    "pyramid": _pyramid,
    "octahedron": _octahedron,
}

# Per-category part schemes (ShapeNet-part style: every category owns a
# contiguous block of the global part-id space). Parts are defined in the
# CANONICAL frame and are z-rotation invariant, so they stay geometrically
# learnable under the augment recipe (rotation is about z only).
SHAPE_PARTS: dict[str, tuple[str, ...]] = {
    "sphere": ("upper_hemisphere", "lower_hemisphere"),
    "cube": ("z_faces", "side_faces"),
    "cylinder": ("side", "top_cap", "bottom_cap"),
    "cone": ("lateral", "base"),
    "torus": ("outer_half", "inner_half"),
    "plane": ("interior", "rim"),
    "pyramid": ("faces", "base"),
    "octahedron": ("upper_half", "lower_half"),
}


def _part_ids(kind: str, pts: np.ndarray) -> np.ndarray:
    """Local part ids for canonical-frame points of `kind` (pre-augment)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    if kind == "sphere":
        return (z < 0).astype(np.int32)
    if kind == "cube":
        return (np.abs(np.abs(z) - 1.0) > 1e-6).astype(np.int32)
    if kind == "cylinder":
        on_cap = np.abs(np.abs(z) - 1.0) < 1e-6
        return np.where(on_cap, np.where(z > 0, 1, 2), 0).astype(np.int32)
    if kind == "cone":
        return (np.abs(z + 1.0) < 1e-6).astype(np.int32)
    if kind == "torus":
        ring = np.sqrt(x**2 + y**2)
        return (ring < 1.0).astype(np.int32)
    if kind == "plane":
        return (np.maximum(np.abs(x), np.abs(y)) > 0.8).astype(np.int32)
    if kind == "pyramid":
        return (np.abs(z + 0.6) < 1e-6).astype(np.int32)
    if kind == "octahedron":
        return (z < 0).astype(np.int32)
    raise ValueError(kind)


def part_offsets(num_categories: int) -> np.ndarray:
    """Global part-id offset per category (first K of SHAPE_CLASSES)."""
    sizes = [len(SHAPE_PARTS[k]) for k in SHAPE_CLASSES[:num_categories]]
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


def part_sizes(num_categories: int) -> np.ndarray:
    """Parts per category (first K of SHAPE_CLASSES), int32."""
    return np.array(
        [len(SHAPE_PARTS[k]) for k in SHAPE_CLASSES[:num_categories]], np.int32
    )


def num_parts_total(num_categories: int) -> int:
    return sum(len(SHAPE_PARTS[k]) for k in SHAPE_CLASSES[:num_categories])


def make_shape_cloud(
    kind: str,
    n_points: int,
    rng: np.random.Generator,
    *,
    augment: bool = True,
    return_parts: bool = False,
):
    """(n_points, 3) float32 surface sample of `kind`, optionally augmented
    with the standard cls recipe (z-rotation, anisotropic scale, jitter,
    translation). Clouds end up centered ~(2, 2, 2) — off-origin by design.

    return_parts=True additionally returns (n_points,) int32 LOCAL part ids
    (SHAPE_PARTS[kind] indices), computed in the canonical frame before
    augmentation."""
    pts = _SAMPLERS[kind](rng, n_points)
    parts = _part_ids(kind, pts) if return_parts else None
    if augment:
        theta = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pts = pts @ rot.T
        pts = pts * rng.uniform(0.7, 1.3, 3)
        pts = pts + rng.normal(0, 0.01, pts.shape).clip(-0.05, 0.05)
        center = rng.uniform(1.5, 2.5, 3)
    else:
        center = np.full(3, 2.0)
    cloud = (pts + center).astype(np.float32)
    return (cloud, parts) if return_parts else cloud


def sample_cls_batch(
    rng: np.random.Generator,
    batch_size: int,
    n_points: int,
    num_classes: int,
    *,
    augment: bool = True,
) -> dict[str, np.ndarray]:
    """One classification batch in the engine's batch-dict convention:
    points (B, N, 3) f32, labels (B,) int32, weights (B,) f32 ones — the
    same dict train_step/eval_step consume (per-row CE weight of 1)."""
    if not 1 <= num_classes <= len(SHAPE_CLASSES):
        raise ValueError(
            f"num_classes must be in [1, {len(SHAPE_CLASSES)}], got {num_classes}"
        )
    labels = rng.integers(0, num_classes, batch_size).astype(np.int32)
    points = np.stack(
        [
            make_shape_cloud(SHAPE_CLASSES[int(l)], n_points, rng, augment=augment)
            for l in labels
        ]
    )
    return {
        "points": points,
        "labels": labels,
        "weights": np.ones(batch_size, np.float32),
    }


def sample_partseg_batch(
    rng: np.random.Generator,
    batch_size: int,
    n_points: int,
    num_categories: int,
    *,
    augment: bool = True,
) -> dict[str, np.ndarray]:
    """One part-segmentation batch in the engine's per-point convention:
    points (B, N, 3 + num_categories) f32 — xyz with the category one-hot
    appended as constant per-point channels (the PointNet2PartSeg input
    convention) — labels (B, N) int32 GLOBAL part ids, weights (B, N) ones,
    category (B,) int32."""
    if not 1 <= num_categories <= len(SHAPE_CLASSES):
        raise ValueError(
            f"num_categories must be in [1, {len(SHAPE_CLASSES)}], got "
            f"{num_categories}"
        )
    offsets = part_offsets(num_categories)
    cats = rng.integers(0, num_categories, batch_size).astype(np.int32)
    points = np.empty((batch_size, n_points, 3 + num_categories), np.float32)
    labels = np.empty((batch_size, n_points), np.int32)
    for i, c in enumerate(cats):
        cloud, parts = make_shape_cloud(
            SHAPE_CLASSES[int(c)], n_points, rng, augment=augment, return_parts=True
        )
        onehot = np.zeros((n_points, num_categories), np.float32)
        onehot[:, int(c)] = 1.0
        points[i] = np.concatenate([cloud, onehot], axis=1)
        labels[i] = parts + offsets[int(c)]
    return {
        "points": points,
        "labels": labels,
        "weights": np.ones((batch_size, n_points), np.float32),
        "category": cats,
    }
