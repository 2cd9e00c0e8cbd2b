"""Surface voxelization for the voxel-level metrics (numpy), the JAX
package's utils/voxel.py: a grid of `res` over the point bbox, linear voxel
id x + y*nx + z*nx*ny, each voxel labelled by the first point np.unique
picks for it (not a majority vote)."""

from __future__ import annotations

import numpy as np

from pointnet2_scannet_tpu_torch.utils import native


def surface_voxel_labels(
    coords: np.ndarray, labels: np.ndarray, res: float = 0.0484
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, 3) coords x (N,) or (N, K) integer labels -> (sorted unique voxel
    ids, the representative point's label row per voxel, grid dimensions)."""
    coordmin = coords.min(axis=0)
    coordmax = coords.max(axis=0)
    nvox = np.ceil((coordmax - coordmin) / res)
    uvidx, vpidx = native.voxelize_unique(coords, res, coordmin, nvox)
    return uvidx, labels[vpidx], nvox
