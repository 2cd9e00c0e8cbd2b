"""PLY I/O: read ScanNet meshes (ascii, binary little- and big-endian),
write coloured point clouds as ascii PLY.

A copy of the JAX package's utils/ply.py (which replaces the reference's
plyfile, lib/pc_util.py:268-295); read_mesh_vertices_rgb_normal takes the
vertex normals from utils/normals.py on the given device.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str | pathlib.Path) -> dict:
    """Parse a PLY file: element name -> structured numpy array; a list
    property (a face's vertex_indices) comes back as an (n, k) int array
    where every row has k items (triangle meshes), else a list of arrays."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements: list[tuple[str, int, list]] = []  # (name, count, props)
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.strip().decode("ascii", "replace").split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append((tokens[4], "list", _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]]))
                else:
                    elements[-1][2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}
        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                out[name] = _parse_ascii_element([f.readline().split() for _ in range(count)], props)
            elif fmt in endian:
                out[name] = _parse_binary_element(f, count, props, endian[fmt])
            else:
                raise ValueError(f"unsupported PLY format {fmt}")
    return out


def _parse_ascii_element(rows, props):
    if not any(len(p) == 4 for p in props):
        arr = np.empty(len(rows), np.dtype([(p[0], p[1]) for p in props]))
        cols = np.array([[float(v) for v in r] for r in rows])
        for i, p in enumerate(props):
            arr[p[0]] = cols[:, i]
        return arr
    return _stack_lists([np.array([int(v) for v in r[1 : 1 + int(r[0])]]) for r in rows])


def _parse_binary_element(f, count, props, endian):
    if not any(len(p) == 4 for p in props):
        dtype = np.dtype([(p[0], endian + p[1]) for p in props])
        return np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
    # an element of one list a row, as ScanNet's faces
    _, _, count_t, item_t = props[0]
    count_dt, item_dt = np.dtype(endian + count_t), np.dtype(endian + item_t)
    lists = []
    for _ in range(count):
        k = int(np.frombuffer(f.read(count_dt.itemsize), count_dt)[0])
        lists.append(np.frombuffer(f.read(item_dt.itemsize * k), item_dt).astype(np.int64))
    return _stack_lists(lists)


def _stack_lists(lists):
    if lists and all(len(x) == len(lists[0]) for x in lists):
        return np.stack(lists)
    return lists


def read_mesh_vertices_rgb_normal(path: str | pathlib.Path, device: torch.device | str = "cuda") -> np.ndarray:
    """(N, 9) float32 [xyz, rgb, normal] of a ScanNet mesh, the normals from
    its faces computed on device (lib/pc_util.py:268-287)."""
    from pointnet2_scannet_tpu_torch.utils.normals import compute_vertex_normals

    data = read_ply(path)
    v = data["vertex"]
    out = np.zeros((len(v), 9), np.float32)
    for i, c in enumerate(("x", "y", "z", "red", "green", "blue")):
        if c in v.dtype.names:
            out[:, i] = v[c]
    if "face" in data and len(data["face"]):
        out[:, 6:9] = compute_vertex_normals(out[:, :3], np.asarray(data["face"]), device=device)
    return out


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
