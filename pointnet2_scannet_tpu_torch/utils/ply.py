"""Write coloured point clouds as ascii PLY."""

from __future__ import annotations

import pathlib

import numpy as np


def write_ply_points(
    path: str | pathlib.Path,
    points: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """Write an ascii PLY point cloud; colors are uint8 RGB."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            colors = np.asarray(colors).astype(np.uint8)
            for p, c in zip(points, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
