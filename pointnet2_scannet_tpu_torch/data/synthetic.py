"""Synthetic ScanNet-like scenes (numpy only): the same scenes from the same
seed as the JAX package's data/synthetic.py.

Each scene is an (N, 11) array in the preprocessed layout — a floor, four
walls and random axis-aligned boxes, each with a class label and a
class-correlated colour.
"""

from __future__ import annotations

import numpy as np

from pointnet2_scannet_tpu_torch.config import NUM_CLASSES


def _class_colors(label: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """n colours of one class: its base colour plus N(0, 12) noise. One
    (n, 3) draw takes the same numbers from the stream as the JAX package's
    n draws of 3."""
    base = np.array(
        [((label * 53) % 256), ((label * 101 + 40) % 256), ((label * 181 + 90) % 256)],
        np.float32,
    )
    return np.clip(base + rng.normal(0, 12, (n, 3)), 0, 255)


def make_synthetic_scene(
    seed: int = 0,
    n_points: int = 60_000,
    extent_xy: float = 6.0,
    height: float = 2.6,
    n_objects: int = 12,
) -> np.ndarray:
    """One synthetic scene; ~40% floor and walls, the rest furniture boxes."""
    rng = np.random.default_rng(seed)
    rows = []

    def emit(pts, normal, label):
        n = len(pts)
        colors = _class_colors(label, n, rng)
        normals = np.tile(np.asarray(normal, np.float32), (n, 1))
        inst = np.full((n, 1), len(rows), np.float32)
        lab = np.full((n, 1), float(label), np.float32)
        rows.append(np.concatenate([pts, colors, normals, inst, lab], axis=1))

    n_floor = n_points // 5
    floor = np.column_stack(
        [
            rng.uniform(0, extent_xy, n_floor),
            rng.uniform(0, extent_xy, n_floor),
            rng.normal(0, 0.01, n_floor),
        ]
    )
    emit(floor, (0, 0, 1), 0)

    n_wall = n_points // 5
    for k in range(4):
        m = n_wall // 4
        t = rng.uniform(0, extent_xy, m)
        z = rng.uniform(0, height, m)
        off = rng.normal(0, 0.01, m)
        if k == 0:
            pts, nrm = np.column_stack([t, off, z]), (0, 1, 0)
        elif k == 1:
            pts, nrm = np.column_stack([t, extent_xy + off, z]), (0, -1, 0)
        elif k == 2:
            pts, nrm = np.column_stack([off, t, z]), (1, 0, 0)
        else:
            pts, nrm = np.column_stack([extent_xy + off, t, z]), (-1, 0, 0)
        emit(pts, nrm, 1)

    n_remaining = n_points - n_floor - 4 * (n_wall // 4)
    per_obj = n_remaining // n_objects
    for _ in range(n_objects):
        label = int(rng.integers(2, NUM_CLASSES))
        cx, cy = rng.uniform(0.5, extent_xy - 0.5, 2)
        sx, sy, sz = rng.uniform(0.3, 1.2, 3)
        face = rng.integers(0, 6, per_obj)
        u = rng.uniform(-0.5, 0.5, per_obj)
        v = rng.uniform(-0.5, 0.5, per_obj)
        pts = np.zeros((per_obj, 3))
        nrm = np.zeros((per_obj, 3))
        for f in range(6):
            m = face == f
            axis, sign = f // 2, 1 if f % 2 else -1
            w = [0.5 * sign if a == axis else None for a in range(3)]
            uv = iter([u[m], v[m]])
            for a in range(3):
                pts[m, a] = w[a] if w[a] is not None else next(uv)
            nrm[m, axis] = sign
        pts = pts * [sx, sy, sz] + [cx, cy, sz / 2]
        emit(pts, (0, 0, 1), label)
        rows[-1][:, 6:9] = nrm

    scene = np.concatenate(rows, axis=0).astype(np.float32)
    return scene[rng.permutation(len(scene))]


def make_synthetic_store(n_scenes: int = 4, seed: int = 0, n_points: int = 60_000):
    """A SceneStore over synthetic scenes, keyed synth0000_00 style."""
    from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore

    scenes = {
        f"synth{idx:04d}_00": make_synthetic_scene(seed + idx, n_points=n_points)
        for idx in range(n_scenes)
    }
    return SceneStore.from_scenes(scenes)


def attach_label_multiview(store, skip=(), seed: int = 7):
    """Give each scene of store not in skip label-correlated (N, 128)
    multiview features, as ENet features carry their class: a fixed class
    embedding N(0, 1) plus N(0, 0.3) noise a point (the JAX package's
    tests/test_multiview_convergence.py fixture). Returns store."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(0.0, 1.0, size=(40, 128)).astype(np.float32)
    for sid in store.scene_ids:
        if sid not in skip:
            labels = store.scenes[sid][:, 10].astype(np.int64)
            store.multiview[sid] = (emb[labels] + rng.normal(0.0, 0.3, (len(labels), 128))).astype(np.float32)
    return store


def make_synthetic_views(points: np.ndarray, n_frames: int, cam, seed: int = 0):
    """Camera poses looking into a scene and the depth maps rendered from its
    points, for the multiview correspondence (data/multiview.py).

    Each camera stands at eye height (1.2-1.8 m) inside the scene's xy box
    and looks at a random point of the scene's middle, with its x axis
    level; camera axes x right, y down, z forward. Each depth map (cam.height,
    cam.width) holds, a pixel, the least camera depth of the points that
    round to it in front of the camera, 0 where none does (an invalid
    pixel). Returns (poses (F, 4, 4), depths (F, H, W)), float32."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(points, np.float64)[:, :3]
    lo, hi = pts.min(0), pts.max(0)
    poses, depths = [], []
    for _ in range(n_frames):
        eye = np.array([*rng.uniform(lo[:2] + 0.2 * (hi[:2] - lo[:2]), hi[:2] - 0.2 * (hi[:2] - lo[:2])),
                        rng.uniform(1.2, 1.8)])
        target = rng.uniform(lo + 0.25 * (hi - lo), hi - 0.25 * (hi - lo))
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, (0.0, 0.0, 1.0))
        right /= np.linalg.norm(right)
        pose = np.eye(4)
        pose[:3, :3] = np.column_stack([right, np.cross(fwd, right), fwd])
        pose[:3, 3] = eye
        cam_pts = (pts - eye) @ pose[:3, :3]
        z = cam_pts[:, 2]
        front = z > 1e-3
        u = np.round(cam_pts[front, 0] * cam.fx / z[front] + cam.cx).astype(np.int64)
        v = np.round(cam_pts[front, 1] * cam.fy / z[front] + cam.cy).astype(np.int64)
        inside = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        depth = np.full(cam.height * cam.width, np.inf)
        np.minimum.at(depth, v[inside] * cam.width + u[inside], z[front][inside])
        depth[np.isinf(depth)] = 0.0
        poses.append(pose)
        depths.append(depth.reshape(cam.height, cam.width))
    return np.stack(poses).astype(np.float32), np.stack(depths).astype(np.float32)
