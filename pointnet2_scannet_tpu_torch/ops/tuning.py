"""Op-lowering switches, read at call time, and the shape routing they select.

The JAX package's ops/tuning.py holds one switch per alternative lowering of
a hot op; its ops read them and add shape conditions of their own. The port
keeps all eleven, with the JAX names and defaults, and copies of their
readers' conditions:

    from pointnet2_scannet_tpu_torch.ops import tuning
    tuning.ops_config.vmem_gather = False
    tuning.ops_config.mxu_gather = True    # the MXU-gather configuration

None means auto: on for a CUDA tensor, the counterpart of the JAX package's
`_on_tpu()`, except for the interpolation switches, whose None is the
gather form on the card as on the CPU (interpolate_route). A route names
the JAX lowering a call takes; the port runs it as follows (on the CPU
every route runs the kernels' plain versions):

- gather_route: "vmem" and "xla" run gather.cu forward and scatter_add.cu
  backward (the port's row gather, since the first slice); "mxu" runs
  gather_smem.cu forward and scatter_smem.cu backward (ops/mxu_gather.py).
- three_nn_route: "t" runs three_nn_kernel, "q" three_nn_q_kernel (the same
  three_nn.cu under its own launch counter), and "xla" (XLA's top-k in the
  JAX package) three_nn_kernel.
- fps_route and ball_query_route: "pallas" and "xla" both run fps.cu and
  ball_query.cu: on the card every route of a point op runs a kernel, so
  fps_pallas and ball_query_pallas change route_counts alone.
- interpolate_route: "gather" (ops.three_interpolate: gather.cu, and
  scatter_add.cu backward), "fast" (gather.cu forward, a dense product
  backward), "cached" and "dense" (dense products; ops/interpolate.py).
- group_segsum: the grouping gathers' backward on scatter_add.cu's
  card-wide sort route (ops/neighborhood.group_points_segsum).

route_counts tallies the routes taken (no launch involved), so a test can
show on the CPU which kernels a run would have launched on the card; its
("pregather", npoint) entries count the set-abstraction scales that ran
layer 0 before the gather (models/modules.py), keyed by the level's
centroid count (1024: SA1).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

_MIB = 1024 * 1024


@dataclasses.dataclass
class OpsConfig:
    # FeaturePropagation's interpolation (JAX ops/tuning.py:25-34, read in
    # the JAX order by interpolate_route): the gather forward with a dense
    # backward; a dense product (None: the gather form here, see
    # interpolate_route); the dense product saving its operator
    interpolate_fast: bool | None = False
    interpolate_dense: bool | None = None
    interpolate_cached: bool = False
    # the grouping gathers' backward as a sort and segment sum (JAX :36)
    group_segsum: bool = False
    # FPS and the single-radius ball query (JAX :39-40): True/False forces,
    # None = auto; routes only (fps_route, ball_query_route)
    fps_pallas: bool | None = None
    ball_query_pallas: bool | None = None
    # the three-NN Pallas kernels (JAX ops/tuning.py:41): True/False forces,
    # None = auto
    three_nn_pallas: bool | None = None
    # grouping gathers as one-hot MXU products (JAX ops/tuning.py:47; off by
    # default there, measured slower than XLA's gather on the TPU)
    mxu_gather: bool | None = False
    # the VMEM chunk-select gather (JAX ops/tuning.py:51); None = auto
    vmem_gather: bool | None = None
    # bfloat16 models group one packed [xyz_hi | xyz_lo | features] bfloat16
    # payload (JAX ops/tuning.py:55; ops/neighborhood.group_with_idx); off,
    # the [xyz | features] concatenation promotes the payload to float32
    packed_bf16_group: bool = True
    # set-abstraction layer 0 before the gather (JAX :62): True/False
    # forces, None = the width and dtype gate (models/modules.py)
    pregather_dense: bool | None = None


ops_config = OpsConfig()
route_counts: collections.Counter = collections.Counter()  # (op, route) -> calls


def reset_route_counts() -> None:
    route_counts.clear()


# --- pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py:41, :66-78, :165-182
_VMEM_BUDGET_BYTES = 10 * _MIB


def _fits(n: int, c: int, ts: int) -> bool:
    return (c * n + 4 * c * ts * 128 + ts * 128) * 4 <= _VMEM_BUDGET_BYTES


def _tile_s(n: int, c: int, s: int) -> int:
    if _fits(n, c, s):
        return s
    cands = [d for d in range(8, s, 8) if s % d == 0 and _fits(n, c, d)]
    return max(cands) if cands else s


def vmem_supported(n: int, j: int, c: int, dtype: torch.dtype) -> bool:
    """vmem_gather_kernel.supported for a (B, n, c) source and j indices."""
    if n % 128 != 0 or j % 128 != 0 or j < 128:
        return False
    if dtype == torch.bfloat16:
        if c % 2 != 0:
            return False
        c //= 2
    elif dtype not in (torch.float32, torch.int32):
        return False
    return _fits(n, c, _tile_s(n, c, j // 128))


# --- pointnet2_scannet_tpu/ops/pallas/gather_kernel.py:29, :265-293
TILE_J = 128


def mxu_supported(n: int, j: int, c: int) -> bool:
    """gather_kernel.supported for a (B, n, c) source and j indices."""
    return (
        n % 128 == 0
        and j % TILE_J == 0
        and n * max(c, 128) * 4 <= 6 * _MIB
        and TILE_J * n * 4 <= 6 * _MIB
    )


def mxu_scatter_supported(n: int, j: int, c: int) -> bool:
    """gather_kernel.scatter_supported: where the JAX package's VMEM-gather
    backward takes the split MXU scatter-add instead of XLA's."""
    return (
        n % 128 == 0
        and 128 <= n <= 2048
        and j % TILE_J == 0
        and TILE_J <= j <= 16384
        and c >= 32
        and (n * c + 6 * TILE_J * c) * 4 <= 8 * _MIB
    )


def gather_route(
    n: int, j: int, c: int, dtype: torch.dtype, use_mxu: bool | None = None, *, auto: bool = True
) -> str:
    """"vmem", "mxu" or "xla": the lowering the JAX package's gather_points
    and group_points (ops/sampling.py:118-141, ops/neighborhood.py:112-140)
    take for a (B, n, c) source of dtype and j indices. use_mxu=True pins the
    MXU gather where supported, False the plain gather; None consults the
    switches. auto: the value of a None switch (True on the card)."""
    if use_mxu is None:
        vmem = ops_config.vmem_gather if ops_config.vmem_gather is not None else auto
        if vmem and vmem_supported(n, j, c, dtype):
            return "vmem"
        use_mxu = ops_config.mxu_gather if ops_config.mxu_gather is not None else auto
    if use_mxu and mxu_supported(n, j, c):
        return "mxu"
    return "xla"


def three_nn_route(n: int, m: int, *, auto: bool = True) -> str:
    """"t", "q" or "xla": the lowering the JAX package's three_nn
    (ops/interpolate.py:42-68) takes for n unknown and m known points:
    the known-major kernel three_nn_pallas_t where n % 128 == 0, m % 8 == 0
    and a query tile of 512, 256 or 128 that divides n keeps its four
    (m, tile) f32 buffers within 8 MiB; else the query-major three_nn_pallas
    where m % 128 == 0 and n % min(n, 256) == 0; else XLA's top-k."""
    use = ops_config.three_nn_pallas if ops_config.three_nn_pallas is not None else auto
    if use and n % 128 == 0 and m % 8 == 0:
        tile_n = min(n, 512)
        while tile_n > 128 and m * tile_n * 16 > 8 * _MIB:
            tile_n //= 2
        if n % tile_n == 0 and m * tile_n * 16 <= 8 * _MIB:
            return "t"
    if use and m % 128 == 0 and n % min(n, 256) == 0:
        return "q"
    return "xla"


# --- pointnet2_scannet_tpu/ops/pallas/ball_query_kernel.py:65-74
def _auto_tile_m(m: int, n: int) -> int:
    tile_m = min(m, 128)
    while tile_m % 2 == 0 and tile_m * n > 128 * 8192:
        tile_m //= 2
    return tile_m


def fps_route(n: int, *, auto: bool = True) -> str:
    """"pallas" or "xla": the lowering the JAX package's
    furthest_point_sample (ops/sampling.py:55-64) takes for n points: the
    Pallas kernel where the switch (or auto) is on and n % 128 == 0."""
    use = ops_config.fps_pallas if ops_config.fps_pallas is not None else auto
    return "pallas" if use and n % 128 == 0 else "xla"


def ball_query_route(n: int, m: int, *, auto: bool = True) -> str:
    """"pallas" or "xla": the lowering the JAX package's ball_query
    (ops/neighborhood.py:56-73) takes for n points and m queries: the
    Pallas kernel where n % 128 == 0, m <= 128 or m % 128 == 0, and the
    kernel's query tile keeps tile * n within 128 * 8192."""
    use = ops_config.ball_query_pallas if ops_config.ball_query_pallas is not None else auto
    if use and n % 128 == 0 and (m <= 128 or m % 128 == 0) and _auto_tile_m(m, n) * n <= 128 * 8192:
        return "pallas"
    return "xla"


def interpolate_route() -> str:
    """"fast", "cached", "dense" or "gather": the interpolation the JAX
    package's FeaturePropagation (models/modules.py:207-223) takes, tested
    in its order. A None switch is off here on the card as on the CPU: the
    JAX auto (dense on the TPU) is a TPU measurement, and the card keeps
    the gather form until a measurement of its own says otherwise."""
    if ops_config.interpolate_fast:
        return "fast"
    if ops_config.interpolate_cached:
        return "cached"
    if ops_config.interpolate_dense:
        return "dense"
    return "gather"
