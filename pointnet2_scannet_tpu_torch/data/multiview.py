"""Multiview 2D -> 3D feature projection (the JAX package's data/multiview.py).

The reference's three offline multiview stages: ENet features a frame
(models/enet.py, 32 x 41 x 128), a point -> pixel correspondence a frame
under a pinhole camera with a depth-consistency test, and a scene's
first-writer-wins fusion of frame features onto points, most-covering frame
first, stored a scene in one HDF5 file that --use_multiview training reads.

Each frame yields a fixed-shape (N,) bool valid mask and (N,) int32 pixel
index. The predicate is the reference's, quirks included: the frustum
planes' dot products are rounded to 0.01 (half to even, as jnp.round) before
the sign test, which culls every point closer than about 0.65 m to the
camera and a band inside each frustum face, as the published features were
made.

Device and rounding. A frame's 4 x 4 constants (the inverted pose, the
frustum's corners and plane normals) are computed on the CPU in float32,
the per-point work on the points' device with one elementwise torch op a
step, in a fixed order (x * m0 + y * m1) + z * m2 + m3 for a row of a
matrix product and x * fx / z + cx for a pixel: a separate op per multiply
and add leaves nothing to contract into a fused multiply-add, so the card
and the CPU give the same bits. Against the JAX package (its matrix
products in XLA's order) a point can flip where a value lies within a few
ulp of a decision threshold; decision_margins says how near each point is.
Pixels are masked before the cast to int32 (a NaN or inf from z <= 0
casts to an undefined value on CUDA), so such points come out invalid with
pix 0, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# intrinsics at the 41 x 32 depth resolution
DEFAULT_INTRINSIC = ((37.01983, 0.0, 20.0), (0.0, 38.52470, 15.5))
DEFAULT_IMAGE_DIMS = (41, 32)  # (W, H)
DEFAULT_DEPTH_MIN = 0.1
DEFAULT_DEPTH_MAX = 4.0
DEFAULT_ACCURACY = 0.05


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = DEFAULT_INTRINSIC[0][0]
    fy: float = DEFAULT_INTRINSIC[1][1]
    cx: float = DEFAULT_INTRINSIC[0][2]
    cy: float = DEFAULT_INTRINSIC[1][2]
    width: int = DEFAULT_IMAGE_DIMS[0]
    height: int = DEFAULT_IMAGE_DIMS[1]
    depth_min: float = DEFAULT_DEPTH_MIN
    depth_max: float = DEFAULT_DEPTH_MAX
    accuracy: float = DEFAULT_ACCURACY


def _rows(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, w: float | None) -> list:
    """Rows of m (F, R, 4) times the points [x, y, z, 1] ((F or 1, N) each),
    or [x, y, z] where w is None: R tensors (F, N), each summed in index
    order, one rounded op a step."""
    out = []
    for r in range(m.shape[1]):
        c = m[:, r, :, None]
        acc = x * c[:, 0] + y * c[:, 1]
        acc = acc + z * c[:, 2]
        out.append(acc if w is None else acc + c[:, 3])
    return out


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, each product and difference its own op."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def _frustum(poses: torch.Tensor, cam: CameraConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's frustum (its corner order and plane normals) a frame,
    float32 on the CPU: anchors (F, 6, 3), the corner each plane's dot
    product is taken from (corner 2 for planes 0-2, corner 4 for 3-5), and
    normals (F, 6, 3)."""
    corners = []
    for d in (cam.depth_min, cam.depth_max):
        for ux, uy in ((0, 0), (cam.width - 1, 0), (cam.width - 1, cam.height - 1), (0, cam.height - 1)):
            corners.append(((ux - cam.cx) / cam.fx * d, (uy - cam.cy) / cam.fy * d, d))
    k = torch.tensor(corners, dtype=torch.float32).T  # (3, 8)
    c = torch.stack(_rows(poses[:, :3], k[0], k[1], k[2], 1.0), -1)  # (F, 8, 3)
    normals = torch.stack([
        _cross(c[:, 3] - c[:, 0], c[:, 1] - c[:, 0]),  # front
        _cross(c[:, 2] - c[:, 1], c[:, 5] - c[:, 1]),  # right
        _cross(c[:, 3] - c[:, 2], c[:, 6] - c[:, 2]),  # roof
        _cross(c[:, 0] - c[:, 3], c[:, 7] - c[:, 3]),  # left
        _cross(c[:, 1] - c[:, 0], c[:, 4] - c[:, 0]),  # bottom
        _cross(c[:, 6] - c[:, 5], c[:, 4] - c[:, 5]),  # back
    ], 1)
    anchors = torch.stack([c[:, 2]] * 3 + [c[:, 4]] * 3, 1)
    return anchors, normals


def _predicate(points, depths, poses, cam: CameraConfig) -> dict:
    """The correspondence's intermediate values, (F, N) each, on the
    points' device: dots (F, N, 6), the unrounded pixel coordinates u, v,
    the camera depth z, the depth at the pixel and the masks."""
    points = torch.as_tensor(points)
    device = points.device
    poses = torch.as_tensor(poses, dtype=torch.float32).cpu()
    w2c = torch.linalg.inv(poses)
    anchors, normals = (t.to(device) for t in _frustum(poses, cam))
    px, py, pz = points.to(torch.float32).T[:, None, :]  # (1, N) each
    x, y, z = _rows(w2c[:, :3].to(device), px, py, pz, 1.0)
    dots = torch.stack([
        _rows(normals[:, j:j + 1], px - anchors[:, j, 0, None], py - anchors[:, j, 1, None],
              pz - anchors[:, j, 2, None], None)[0] for j in range(6)], -1)
    in_frustum = (torch.round(dots * 100.0) / 100.0 < 0).all(-1)
    u = x * cam.fx / z + cam.cx
    v = y * cam.fy / z + cam.cy
    ui, vi = torch.round(u), torch.round(v)
    in_image = (ui >= 0) & (vi >= 0) & (ui < cam.width) & (vi < cam.height)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    pix = (torch.where(in_image, vi, zero).to(torch.int32) * cam.width
           + torch.where(in_image, ui, zero).to(torch.int32))
    depths = torch.as_tensor(depths, dtype=torch.float32, device=device)
    d = torch.gather(depths.reshape(depths.shape[0], -1), 1, pix.long())
    consistent = (d >= cam.depth_min) & (d <= cam.depth_max) & ((d - z).abs() <= cam.accuracy)
    return {"dots": dots, "u": u, "v": v, "z": z, "d": d, "pix": pix,
            "valid": in_frustum & in_image & consistent}


def compute_correspondence_batch(
    points: torch.Tensor,
    depths,
    poses,
    cam: CameraConfig = CameraConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Point -> pixel correspondence of F frames, on the points' device.

    The predicate chain is the reference's: quantised frustum cull ->
    rounded pixel inside the image -> pixel depth in [depth_min, depth_max]
    -> |pixel depth - point depth| <= accuracy.

    points (N, 3) world coordinates (a tensor); depths (F, H, W) at the
    feature resolution; poses (F, 4, 4) camera-to-world (tensors or numpy).
    Returns valid (F, N) bool and pix (F, N) int32, y * W + x (0 where
    invalid)."""
    p = _predicate(points, depths, poses, cam)
    valid = p["valid"]
    return valid, torch.where(valid, p["pix"], torch.zeros((), dtype=torch.int32, device=valid.device))


def compute_correspondence(points, depth, camera_to_world, cam: CameraConfig = CameraConfig()):
    """One frame: depth (H, W), camera_to_world (4, 4) -> valid (N,), pix (N,)."""
    valid, pix = compute_correspondence_batch(
        points, torch.as_tensor(depth)[None], torch.as_tensor(camera_to_world)[None], cam)
    return valid[0], pix[0]


def decision_margins(points, depths, poses, cam: CameraConfig = CameraConfig()) -> torch.Tensor:
    """(F, N) float64: how near each point's correspondence lies to one of
    its decisions, in that decision's own units: a frustum dot product
    times 100, or a pixel coordinate, from a rounding boundary (half an
    integer: the sign test and the image bounds fall there too), the depth
    difference from the accuracy, the pixel depth from its range (inf
    where z <= 0 leaves no finite pixel). A point whose result differs
    between two implementations lies within their rounding difference of
    one of these."""
    p = _predicate(points, depths, poses, cam)
    half = lambda t: (t - torch.floor(t) - 0.5).abs()  # noqa: E731
    d = p["d"].double()
    margins = torch.stack([
        half(p["dots"].double() * 100.0).amin(-1), half(p["u"].double()), half(p["v"].double()),
        ((d - p["z"].double()).abs() - cam.accuracy).abs(),
        (d - cam.depth_min).abs(), (d - cam.depth_max).abs()])
    return margins.nan_to_num(nan=float("inf")).amin(0)


def project_frame_features(features: torch.Tensor, valid: torch.Tensor, pix: torch.Tensor,
                           num_points: int) -> torch.Tensor:
    """One frame's (H, W, C) features onto (num_points, C) slots, zero where
    invalid; valid and pix (num_points,) from compute_correspondence."""
    if valid.shape != (num_points,) or pix.shape != (num_points,):
        raise ValueError(f"valid {tuple(valid.shape)} and pix {tuple(pix.shape)} are not ({num_points},)")
    out = features.reshape(-1, features.shape[-1])[pix.long()]
    return torch.where(valid[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def fuse_scene_features(frame_features: torch.Tensor, valids: torch.Tensor,
                        pixes: torch.Tensor) -> torch.Tensor:
    """First-writer-wins fusion over frames, the most-covering frame first
    (a stable descending sort by coverage), on the features' device.

    frame_features (F, H, W, C), valids (F, N) bool, pixes (F, N) int32 ->
    (N, C), zero where no frame covered the point. Each point takes the
    feature of the first frame in that order whose mask holds it, which is
    what the JAX package's frame-by-frame loop writes."""
    f, h, w, c = frame_features.shape
    order = torch.argsort(-valids.sum(1), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(f, device=order.device)
    key = torch.where(valids, rank[:, None], torch.full_like(rank[:, None], f))
    first_rank, first = key.min(0)
    rows = first * (h * w) + torch.gather(pixes.long(), 0, first[None])[0]
    out = frame_features.reshape(f * h * w, c)[rows]
    covered = (first_rank < f)[:, None]
    return torch.where(covered, out, torch.zeros((), dtype=out.dtype, device=out.device))


def write_multiview_h5(path, scene_features: dict[str, np.ndarray]) -> None:
    """Store each scene's (N, 128) fused features in one HDF5 file, keyed by
    scene id (the layout SceneStore.from_npy_dir reads)."""
    import h5py

    with h5py.File(path, "w") as f:
        for sid, feats in scene_features.items():
            f.create_dataset(sid, data=np.asarray(feats), compression="gzip")
