"""Virtual-scan scene subsampling, on the device.

The JAX package's utils/scene_util.py (the reference's lib/scene_util.py
virtual_scan, :18-66, dead code there but part of its inventory): keep the
points that a virtual camera at human height sees, those near one of its
200 x 150 rays and nearest the camera on their ray (a z-buffer).

The camera is drawn and posed on the host with numpy, as the JAX function
does it, so that a numpy generator gives the same camera. Every per-point
step runs as torch ops on the device, in the dtypes numpy's promotion gives
the JAX function: float32 points keep their offsets, directions and
spherical coordinates in float32, the image-plane coordinates and the
angular distance are float64. The z-buffer loop becomes one per-ray
scatter_reduce("amin") over the hit points, then keeps r <= min_r[ray]: the
loop's rule, ties kept.
"""

from __future__ import annotations

import numpy as np
import torch

# virtual sensor: 200 x 150 rays spanning +-0.6 x +-0.45 on the image plane
# at unit focal distance (reference :33-35)
GRID_X, GRID_Y = 200, 150
SPAN_X, SPAN_Y = 0.6, 0.45
MAX_ANGULAR_DIST = 0.01  # radians; reference :48
MIN_POINTS = 100


def cart2sph(xyz: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 3) (azimuth, elevation, radius) (reference :8-15), in
    xyz's dtype."""
    x, y, z = xyz.unbind(-1)
    xy = x * x + y * y
    return torch.stack([torch.atan2(y, x), torch.atan2(z, torch.sqrt(xy)), torch.sqrt(xy + z * z)], dim=-1)


def _camera(xyz: np.ndarray, mode: int, rng: np.random.Generator):
    """The JAX function's camera: position (xyz's dtype), view angles, and
    the centre ray and image-plane axes (float64)."""
    camloc = xyz.mean(axis=0)
    camloc[2] = 1.5  # human height (reference :21)
    if mode == -1:
        view = np.array([2 * np.pi * rng.random(), np.pi / 10 * (rng.random() - 0.75)])
        camloc[:2] -= (0.8 + 0.7 * rng.random()) * np.array([np.cos(view[0]), np.sin(view[0])])
    else:
        view = np.array([np.pi / 4 * mode, 0.0])
        camloc[:2] -= np.array([np.cos(view[0]), np.sin(view[0])])
    ct = np.array([np.cos(view[1]) * np.cos(view[0]), np.cos(view[1]) * np.sin(view[0]), np.sin(view[1])])
    hr = np.cross(ct, [0.0, 0.0, 1.0])
    hr /= np.linalg.norm(hr)
    vt = np.cross(hr, ct)
    vt /= np.linalg.norm(vt)
    return camloc, ct, hr, vt


def virtual_scan(xyz: np.ndarray, mode: int = -1, rng: np.random.Generator | None = None,
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """Sorted int64 indices (on device) of the points of xyz (N, 3) visible
    from a virtual camera; none where fewer than MIN_POINTS are near a ray.
    mode -1 draws the camera from rng (unseeded by default), mode k looks
    along azimuth k * pi / 4."""
    g = scan_geometry(xyz, mode, rng, device)
    hit, ray, r = g["hit"], g["ray"], g["r"]
    if int(hit.sum()) < MIN_POINTS:
        return torch.zeros(0, dtype=torch.int64, device=device)
    # the z-buffer: the nearest distance on each ray, ties kept (reference :52-63)
    min_r = torch.full((GRID_X * GRID_Y,), float("inf"), dtype=r.dtype, device=device)
    min_r = min_r.scatter_reduce(0, ray[hit], r[hit], "amin")
    return torch.nonzero(hit & (r <= min_r[ray])).flatten()


def scan_geometry(xyz: np.ndarray, mode: int = -1, rng: np.random.Generator | None = None,
                  device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """virtual_scan's per-point decisions on device: "ray" (each point's
    nearest ray), "ang" (the angular distance to it, float64), "r" (the
    distance to the camera) and "hit" (in front and ang < MAX_ANGULAR_DIST).
    Where two devices' scans differ, these show how near each differing
    point lies to a threshold."""
    xyz = np.asarray(xyz)
    camloc, ct, hr, vt = _camera(xyz, mode, rng or np.random.default_rng())
    f64 = dict(dtype=torch.float64, device=device)
    ct_t, hr_t, vt_t = (torch.tensor(a, **f64) for a in (ct, hr, vt))

    d = torch.as_tensor(xyz, device=device) - torch.as_tensor(camloc, device=device)
    local = cart2sph(d)  # (az, el, r) of every point

    # the ray grid in spherical coordinates
    gy, gx = torch.meshgrid(torch.linspace(-SPAN_Y, SPAN_Y, GRID_Y, **f64),
                            torch.linspace(-SPAN_X, SPAN_X, GRID_X, **f64), indexing="ij")
    rays = gx.reshape(-1, 1) * hr_t + gy.reshape(-1, 1) * vt_t + ct_t
    rays_ae = cart2sph(rays)[:, :2]

    # each point's nearest ray: its direction on the image plane, quantised
    # to the grid, then the angular distance to that ray
    sq = d * d
    dn = (d / torch.sqrt((sq[:, 0:1] + sq[:, 1:2]) + sq[:, 2:3])).to(torch.float64)

    def dot(axis: torch.Tensor) -> torch.Tensor:
        return (dn[:, 0] * axis[0] + dn[:, 1] * axis[1]) + dn[:, 2] * axis[2]

    depth = dot(ct_t)
    in_front = depth > 1e-6
    depth = torch.clamp(depth, min=1e-6)
    u = torch.where(in_front, dot(hr_t) / depth, 1e9)
    v = torch.where(in_front, dot(vt_t) / depth, 1e9)
    ix = torch.clamp(torch.round((u + SPAN_X) / (2 * SPAN_X) * (GRID_X - 1)), 0, GRID_X - 1).long()
    iy = torch.clamp(torch.round((v + SPAN_Y) / (2 * SPAN_Y) * (GRID_Y - 1)), 0, GRID_Y - 1).long()
    ray = iy * GRID_X + ix
    gap = local[:, :2] - rays_ae[ray]  # float64
    sq = gap * gap
    ang = torch.sqrt(sq[:, 0] + sq[:, 1])

    return {"ray": ray, "ang": ang, "r": local[:, 2], "hit": in_front & (ang < MAX_ANGULAR_DIST)}
