"""Point-cloud ops of the port, channels-last, dispatched by device.

A CPU tensor runs the op's plain PyTorch version; a CUDA tensor launches the
hand-written kernel in ops/cuda/ (or raises). Indices are int32 throughout.
The kernels a serving forward launches are reached through the pn2::
torch.library ops of ops/library.py, which this package registers.
"""

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.fused_sa import fused_gather_mm
from pointnet2_scannet_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_interpolate_cached,
    three_interpolate_dense,
    three_interpolate_fast,
    three_nn,
)
from pointnet2_scannet_tpu_torch.ops.neighborhood import (
    ball_query,
    ball_query_multi,
    group_all,
    group_points,
    group_with_idx,
    query_and_group,
    uniform_resample_neighbors,
    unique_neighbor_count,
)
from pointnet2_scannet_tpu_torch.ops.sampling import furthest_point_sample, gather_points
from pointnet2_scannet_tpu_torch.ops import library  # noqa: F401  (registers pn2::; last: its impls read the modules above)

__all__ = [
    "pairwise_sqdist",
    "furthest_point_sample",
    "gather_points",
    "ball_query",
    "ball_query_multi",
    "group_points",
    "group_with_idx",
    "query_and_group",
    "group_all",
    "unique_neighbor_count",
    "uniform_resample_neighbors",
    "three_nn",
    "three_interpolate",
    "three_interpolate_dense",
    "three_interpolate_cached",
    "three_interpolate_fast",
    "fused_gather_mm",
]
