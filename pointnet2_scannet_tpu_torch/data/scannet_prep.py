"""ScanNet raw-scan preprocessing, the vertex normals on the device.

A copy of the JAX package's data/scannet_prep.py (the reference's
preprocessing/collect_scannet_scenes.py:17-104 and scannet_util.py:7-26):
per scene, read the `_vh_clean_2.ply` mesh, the over-segmentation JSON and
the aggregation JSON; map raw instance labels to the 20 NYU classes through
scannetv2-labels.combined.tsv (unknown -> 'otherprop'); compute the vertex
normals from the mesh faces (utils/normals.py, on device); emit an (N, 11)
float32 array [xyz, rgb (0-255), normal, instance_label, semantic_label],
subsampled to at most max_points (the reference's NUM_MAX_PTS 100 000) by
the same numpy draw as the JAX function, so the same rows.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import NYU_CLASSES

MAX_POINTS = 100_000


def load_label_map(tsv_path: str | pathlib.Path) -> dict[str, str]:
    """raw_category -> NYU-20 class name ('otherprop' when unmapped); a TSV
    without those headers is read at the reference's columns 1 and 7."""
    valid = set(NYU_CLASSES)
    mapping: dict[str, str] = {}
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        try:
            raw_col, nyu_col = header.index("raw_category"), header.index("nyu40class")
        except ValueError:
            raw_col, nyu_col = 1, 7
            f.seek(0)
            f.readline()
        for line in f:
            cells = line.rstrip("\n").split("\t")
            if len(cells) <= max(raw_col, nyu_col):
                continue
            mapping[cells[raw_col]] = cells[nyu_col] if cells[nyu_col] in valid else "otherprop"
    return mapping


def collect_scene(
    scan_dir: str | pathlib.Path,
    scene_id: str,
    label_map: dict[str, str],
    *,
    max_points: int = MAX_POINTS,
    rng: np.random.Generator | None = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """One scene's (N, 11) labelled point array; rng draws the subsample
    (default_rng(0), as in the JAX function)."""
    from pointnet2_scannet_tpu_torch.utils.ply import read_mesh_vertices_rgb_normal

    rng = rng or np.random.default_rng(0)
    scan_dir = pathlib.Path(scan_dir) / scene_id
    mesh = read_mesh_vertices_rgb_normal(scan_dir / f"{scene_id}_vh_clean_2.ply", device=device)
    segs = json.loads((scan_dir / f"{scene_id}_vh_clean_2.0.010000.segs.json").read_text())
    seg_ids = np.asarray(segs["segIndices"], np.int64)  # a segment id a vertex
    agg = json.loads((scan_dir / f"{scene_id}.aggregation.json").read_text())

    rows = []
    for inst_idx, group in enumerate(agg["segGroups"]):
        sem = NYU_CLASSES.index(label_map.get(group["label"], "otherprop"))
        pts = mesh[np.isin(seg_ids, np.asarray(group["segments"], np.int64))]
        if len(pts) == 0:
            continue
        inst = np.full((len(pts), 1), float(inst_idx), np.float32)
        lab = np.full((len(pts), 1), float(sem), np.float32)
        rows.append(np.concatenate([pts, inst, lab], axis=1))
    if not rows:
        raise ValueError(f"scene {scene_id} has no labeled instances")
    data = np.concatenate(rows, axis=0)
    if len(data) > max_points:
        data = data[rng.choice(len(data), max_points, replace=False)]
    return data.astype(np.float32)


def collect_scenes(
    scans_dir: str | pathlib.Path,
    scene_ids: list[str],
    tsv_path: str | pathlib.Path,
    output_dir: str | pathlib.Path,
    *,
    skip_errors: bool = True,
    device: torch.device | str = "cuda",
) -> list[str]:
    """Preprocess scene_ids into output_dir/<scene>.npy; returns the ids
    done. A scene that fails is logged and skipped, as the reference's
    try/except-continue does (collect_scannet_scenes.py:101-102)."""
    label_map = load_label_map(tsv_path)
    out = pathlib.Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    done = []
    for sid in scene_ids:
        try:
            np.save(out / f"{sid}.npy", collect_scene(scans_dir, sid, label_map, device=device))
            done.append(sid)
        except Exception as e:  # noqa: BLE001  (the reference skips any failing scene)
            if not skip_errors:
                raise
            print(f"ERROR processing {sid}: {e}")
    return done
