"""Per-vertex normals of a triangle mesh, on the device.

The reference's compute_normal (lib/pc_util.py:213-232) as the JAX package's
utils/normals.py computes it: each face's unnormalised cross product (in the
vertices' dtype) added in float64 onto its three vertices, then each vertex's
sum L2-normalised; a vertex whose sum is zero (isolated, or of zero-area
faces only) gets a zero normal. On the CPU the sums add in face order, as
numpy's add.at does; on the card index_add_'s atomics add in no fixed order,
so the normals there agree to about 1e-7, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray,
                           device: torch.device | str = "cuda") -> np.ndarray:
    """(N, 3) vertices, (F, 3) int faces -> (N, 3) float32 unit normals."""
    v = torch.as_tensor(np.asarray(vertices), device=device)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=device)
    tris = v[f]  # (F, 3, 3)
    a, b = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    # numpy's cross, each product and difference rounded on its own
    fn = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                      a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                      a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1).to(torch.float64)
    normals = torch.zeros(v.shape, dtype=torch.float64, device=device)
    for k in range(3):
        normals.index_add_(0, f[:, k], fn)
    sq = normals * normals
    norm = torch.sqrt((sq[:, 0:1] + sq[:, 1:2]) + sq[:, 2:3])
    norm = torch.where(norm == 0, torch.ones((), dtype=norm.dtype, device=device), norm)
    return (normals / norm).to(torch.float32).cpu().numpy()
