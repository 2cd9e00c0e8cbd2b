"""The port's point ops against the JAX package on the CPU.

Each op gets the same numpy inputs in both packages and is held against
three references: the JAX op (its XLA path on the CPU), the Pallas kernel it
replaces run in interpret mode at shapes that kernel accepts, and the loop
oracles of tests/oracles.py. Index outputs and gathers must match all
three bit for bit, and squared distances must match the JAX op bit for bit
(the jitted interpret-mode kernel contracts into fma; see
_assert_fma_close). On the CPU the port runs each kernel's plain PyTorch
version; the CUDA kernels themselves are held against those plain versions
in tests/test_torch_port_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.ops import interpolate as jinterp
from pointnet2_scannet_tpu.ops import neighborhood as jnb
from pointnet2_scannet_tpu.ops import sampling as jsamp
from pointnet2_scannet_tpu.ops.pallas.ball_query_kernel import ball_query_pallas
from pointnet2_scannet_tpu.ops.pallas.fps_kernel import furthest_point_sample_pallas
from pointnet2_scannet_tpu.ops.pallas.three_nn_kernel import three_nn_pallas_t
from pointnet2_scannet_tpu.ops.pallas.vmem_gather_kernel import vmem_gather_any
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.ops import cuda as kernels
from pointnet2_scannet_tpu_torch.ops.cuda import build
from tests import oracles


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _np(t):
    return t.detach().cpu().numpy()


def _cloud(seed, shape, lo=0.0, hi=1.5):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


# ----------------------------------------------------------------- FPS


def _near_origin_cloud():
    xyz = _cloud(11, (2, 256, 3), 0.5, 1.5)
    xyz[0, 5] = [0.01, 0.0, 0.01]  # |p|^2 = 2e-4: never picked
    xyz[1, 7] = [0.0, 0.0, 0.0]  # a scene corner at the origin
    return xyz


def _duplicate_cloud():
    xyz = _cloud(12, (2, 128, 3))
    xyz[:, 64:] = xyz[:, :64]  # every point twice: exact min-distance ties
    return xyz


FPS_CASES = {
    "random": (lambda: _cloud(10, (3, 256, 3)), 64),
    "near_origin_skip": (_near_origin_cloud, 96),
    "duplicates": (_duplicate_cloud, 100),
}


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_matches_jax_pallas_and_oracle(case):
    make, npoint = FPS_CASES[case]
    xyz = make()
    got = _np(ops.furthest_point_sample(_t(xyz), npoint))
    assert got.dtype == np.int32
    want_xla = np.asarray(jsamp.furthest_point_sample(jnp.asarray(xyz), npoint, use_pallas=False))
    want_pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, oracles.fps_oracle(xyz, npoint))
    if case == "near_origin_skip":
        assert 5 not in got[0] and 7 not in got[1]


@pytest.mark.parametrize("n", [64, 200])
def test_fps_unaligned_n_matches_jax(n):
    # the SA4 size (N=64) and a ragged N: no Pallas kernel takes these, the
    # port's kernel does, with the same contract
    xyz = _cloud(13, (2, n, 3))
    got = _np(ops.furthest_point_sample(_t(xyz), 16))
    want = np.asarray(jsamp.furthest_point_sample(jnp.asarray(xyz), 16, use_pallas=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracles.fps_oracle(xyz, 16))


def test_fps_without_skip_can_pick_the_origin():
    xyz = _cloud(14, (1, 128, 3), 0.5, 1.5)
    xyz[0, 9] = 0.0
    got = _np(ops.furthest_point_sample(_t(xyz), 8, skip_near_origin=False))
    want = np.asarray(
        jsamp.furthest_point_sample(jnp.asarray(xyz), 8, skip_near_origin=False, use_pallas=False)
    )
    np.testing.assert_array_equal(got, want)
    assert 9 in got[0]


def _large_cloud(n):
    """One row of n points past one block's 16384 on the card: every point
    twice (exact min-distance ties at every step) and two near the origin."""
    xyz = _cloud(n, (1, n, 3))
    xyz[0, n // 2:] = xyz[0, : n - n // 2]
    xyz[0, 3] = [0.01, 0.0, 0.01]  # |p|^2 = 2e-4: never picked
    xyz[0, n - 5] = [0.0, 0.0, 0.0]
    return xyz


@pytest.mark.parametrize("n", [20000, 32768])
def test_fps_at_large_n_matches_jax_and_oracle(n):
    xyz = _large_cloud(n)
    got = _np(ops.furthest_point_sample(_t(xyz), 64))
    want = np.asarray(jsamp.furthest_point_sample(jnp.asarray(xyz), 64, use_pallas=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracles.fps_oracle(xyz, 64))
    assert 3 not in got[0] and n - 5 not in got[0]


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_fps_dtypes_match_jax(dtype):
    # float64 stays float64 (held to the float64 oracle too); bfloat16
    # computes in float32 on both sides
    xyz = _cloud(14, (2, 700, 3))
    if dtype == "float64":
        xyz = xyz.astype(np.float64) * (1 + 1e-12)  # values float32 cannot hold
        src = torch.from_numpy(xyz)
    else:
        src = _t(xyz).to(torch.bfloat16)
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        jx = jnp.asarray(xyz) if dtype == "float64" else jnp.asarray(xyz).astype(jnp.bfloat16)
        want = np.asarray(jsamp.furthest_point_sample(jx, 96, use_pallas=False))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = _np(ops.furthest_point_sample(src, 96))
    np.testing.assert_array_equal(got, want)
    if dtype == "float64":
        np.testing.assert_array_equal(got, oracles.fps_oracle(xyz, 96))
    else:
        np.testing.assert_array_equal(got, _np(ops.furthest_point_sample(src.float(), 96)))


# --------------------------------------------------------- ball query


def _ball_inputs(seed, n=256, m=64):
    xyz = _cloud(seed, (2, n, 3))
    q = xyz[:, :m].copy()
    return xyz, q


@pytest.mark.parametrize("radius,nsample", [(0.1, 32), (0.3, 16), (0.5, 8)])
def test_ball_query_matches_jax_pallas_and_oracle(radius, nsample):
    xyz, q = _ball_inputs(20)
    got = _np(ops.ball_query(radius, nsample, _t(xyz), _t(q)))
    assert got.dtype == np.int32
    want_xla = np.asarray(jnb.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(q), use_pallas=False))
    want_pallas = np.asarray(
        ball_query_pallas(radius, nsample, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    )
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, oracles.ball_query_oracle(radius, nsample, xyz, q))


def test_ball_query_empty_ball_gives_zeros_and_short_row_pads_first_hit():
    xyz = _cloud(21, (1, 128, 3), 0.5, 1.0)
    q = np.array([[[5.0, 5.0, 5.0], [0.0, 0.0, 0.0], [0.75, 0.75, 0.75]]], np.float32)
    xyz[0, 40] = [0.02, 0.0, 0.0]  # the only point near the origin query
    xyz[0, 90] = [0.0, 0.03, 0.0]
    got = _np(ops.ball_query(0.1, 8, _t(xyz), _t(q)))
    np.testing.assert_array_equal(got[0, 0], np.zeros(8, np.int32))  # empty ball
    np.testing.assert_array_equal(got[0, 1], [40, 90, 40, 40, 40, 40, 40, 40])
    for want in (
        np.asarray(jnb.ball_query(0.1, 8, jnp.asarray(xyz), jnp.asarray(q), use_pallas=False)),
        np.asarray(ball_query_pallas(0.1, 8, jnp.asarray(xyz), jnp.asarray(q), interpret=True)),
        oracles.ball_query_oracle(0.1, 8, xyz, q),
    ):
        np.testing.assert_array_equal(got, want)


def test_ball_query_radius_boundary_is_exclusive():
    # a point at exactly d^2 == f32(r)^2 is outside; one ulp inside is in
    r = np.float32(0.25)
    xyz = np.zeros((1, 128, 3), np.float32)
    xyz[0, :, 0] = 3.0
    xyz[0, 3, 0] = r  # d^2 = r*r exactly
    xyz[0, 4, 0] = np.nextafter(r, np.float32(0))
    q = np.zeros((1, 1, 3), np.float32)
    got = _np(ops.ball_query(0.25, 4, _t(xyz), _t(q)))
    np.testing.assert_array_equal(got[0, 0], [4, 4, 4, 4])
    want = np.asarray(ball_query_pallas(0.25, 4, jnp.asarray(xyz), jnp.asarray(q), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_ball_query_nsample_beyond_n_matches_oracle():
    # more slots than points (the JAX op's top_k refuses this shape): every
    # point is a hit and the tail repeats the first hit
    xyz = _cloud(22, (2, 16, 3))
    q = xyz[:, :4].copy()
    got = _np(ops.ball_query(2.0, 32, _t(xyz), _t(q)))
    np.testing.assert_array_equal(got, oracles.ball_query_oracle(2.0, 32, xyz, q))


# ------------------------------------------------------------ gathers


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_points_matches_jax_and_vmem_kernel(dtype):
    rng = np.random.default_rng(30)
    src = (rng.normal(size=(2, 256, 9)) * 100).astype(dtype)
    idx = rng.integers(0, 256, (2, 384)).astype(np.int32)
    got = _np(ops.gather_points(_t(src), _t(idx)))
    assert got.dtype == dtype
    want_xla = np.asarray(jsamp.gather_points(jnp.asarray(src), jnp.asarray(idx), use_mxu=False))
    want_pallas = np.asarray(vmem_gather_any(jnp.asarray(src), jnp.asarray(idx), interpret=True))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


def test_group_points_matches_jax_and_oracle():
    rng = np.random.default_rng(31)
    src = rng.normal(size=(2, 128, 67)).astype(np.float32)
    idx = rng.integers(0, 128, (2, 16, 8)).astype(np.int32)
    got = _np(ops.group_points(_t(src), _t(idx)))
    want = np.asarray(jnb.group_points(jnp.asarray(src), jnp.asarray(idx), use_mxu=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracles.group_points_oracle(src, idx))


@pytest.mark.parametrize("with_features", [True, False])
def test_query_and_group_matches_jax(with_features):
    xyz, q = _ball_inputs(32)
    feats = np.random.default_rng(33).normal(size=(2, 256, 6)).astype(np.float32)
    f = feats if with_features else None
    got = _np(ops.query_and_group(0.3, 16, _t(xyz), _t(q), None if f is None else _t(f)))
    want = np.asarray(
        jnb.query_and_group(0.3, 16, jnp.asarray(xyz), jnp.asarray(q), None if f is None else jnp.asarray(f))
    )
    assert got.shape == (2, 64, 16, 9 if with_features else 3)
    np.testing.assert_array_equal(got, want)


def test_group_with_idx_and_group_all_match_jax():
    xyz, q = _ball_inputs(34)
    feats = np.random.default_rng(35).normal(size=(2, 256, 4)).astype(np.float32)
    idx = np.asarray(jnb.ball_query(0.3, 8, jnp.asarray(xyz), jnp.asarray(q), use_pallas=False))
    for f in (feats, None):
        got = _np(ops.group_with_idx(_t(idx), _t(xyz), _t(q), None if f is None else _t(f)))
        want = np.asarray(jnb.group_with_idx(
            jnp.asarray(idx), jnp.asarray(xyz), jnp.asarray(q), None if f is None else jnp.asarray(f)
        ))
        np.testing.assert_array_equal(got, want)
    got = _np(ops.group_with_idx(_t(idx), _t(xyz), _t(q), _t(feats), use_xyz=False))
    np.testing.assert_array_equal(got, oracles.group_points_oracle(feats, idx))
    got_all = _np(ops.group_all(_t(xyz), _t(feats)))
    np.testing.assert_array_equal(got_all, np.asarray(jnb.group_all(jnp.asarray(xyz), jnp.asarray(feats))))


# --------------------------------------------------------------- 3-NN


def _assert_fma_close(d2, jitted_d2):
    """d2 rounds every operation of ((dx*dx + dy*dy) + dz*dz), as the JAX op
    run eagerly and numpy do; XLA's CPU compiler contracts a*b + c into an
    fma inside a jitted program (the interpret-mode Pallas kernel), which
    moves a squared distance by at most two units in the last place."""
    np.testing.assert_array_max_ulp(d2, jitted_d2, maxulp=2)


@pytest.mark.parametrize("n,m", [(256, 64), (384, 128), (128, 16)])
def test_three_nn_matches_jax_pallas_and_oracle(n, m):
    unknown = _cloud(40 + n, (2, n, 3))
    known = _cloud(41 + m, (2, m, 3))
    d2, idx = ops.three_nn(_t(unknown), _t(known))
    d2, idx = _np(d2), _np(idx)
    assert idx.dtype == np.int32 and d2.dtype == np.float32
    jd2, jidx = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known), use_pallas=False)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(d2, np.asarray(jd2))
    pd2, pidx = three_nn_pallas_t(jnp.asarray(unknown), jnp.asarray(known), tile_n=128, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(pidx))
    _assert_fma_close(d2, np.asarray(pd2))
    od2, oidx = oracles.three_nn_oracle(unknown, known)
    np.testing.assert_array_equal(idx, oidx)
    np.testing.assert_allclose(d2, od2.astype(np.float32), rtol=1e-6)


def test_three_nn_duplicated_points_tie_to_lowest_index():
    known = np.zeros((1, 16, 3), np.float32)
    known[0, :, 0] = [0.5, 0.5, 0.5, 2.0, 2.0, 3.0, 3.0, 3.0,
                      4.0, 4.0, 4.0, 4.0, 5.0, 5.0, 5.0, 5.0]
    unknown = np.zeros((1, 128, 3), np.float32)
    unknown[0, :, 0] = np.linspace(0.0, 6.0, 128)
    d2, idx = ops.three_nn(_t(unknown), _t(known))
    np.testing.assert_array_equal(_np(idx)[0, 0], [0, 1, 2])
    pd2, pidx = three_nn_pallas_t(jnp.asarray(unknown), jnp.asarray(known), interpret=True)
    np.testing.assert_array_equal(_np(idx), np.asarray(pidx))
    _assert_fma_close(_np(d2), np.asarray(pd2))
    jd2, jidx = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known), use_pallas=False)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(d2), np.asarray(jd2))
    np.testing.assert_array_equal(_np(idx), oracles.three_nn_oracle(unknown, known)[1])


def test_three_interpolate_matches_jax_and_oracle():
    rng = np.random.default_rng(50)
    points = rng.normal(size=(2, 64, 32)).astype(np.float32)
    idx = rng.integers(0, 64, (2, 256, 3)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (2, 256, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    got = _np(ops.three_interpolate(_t(points), _t(idx), _t(w)))
    want = np.asarray(jinterp.three_interpolate(jnp.asarray(points), jnp.asarray(idx), jnp.asarray(w)))
    # float output: the port sums the three terms in a written-out order;
    # f32 rounding of a three-term sum bounds any difference
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, oracles.three_interpolate_oracle(points, idx, w), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ dispatch


def test_cpu_tensors_take_the_plain_versions_without_counting():
    kernels.reset_launch_counts()
    xyz = _t(_cloud(60, (1, 128, 3))).requires_grad_(True)
    centroids = ops.gather_points(xyz, ops.furthest_point_sample(xyz.detach(), 16))
    ops.ball_query(0.2, 8, xyz.detach(), centroids.detach())
    ops.ball_query_multi((0.1, 0.2), (4, 8), xyz.detach(), centroids.detach())
    ops.three_nn(xyz.detach(), xyz[:, :16].detach())
    ops.three_nn(xyz[:, :100].detach(), xyz.detach())  # n % 128 != 0
    grouped = ops.group_points(xyz, torch.zeros((1, 16, 8), dtype=torch.int32), use_mxu=True)
    (centroids.sum() + grouped.sum()).backward()  # the gathers' backwards: plain scatter-adds
    assert xyz.grad is not None
    ops.fused_gather_mm(xyz.detach(), torch.zeros((1, 128), dtype=torch.int32), torch.ones((3, 4)))
    assert kernels.launch_counts() == {
        "furthest_point_sample": 0, "ball_query": 0, "gather": 0, "three_nn": 0,
        "scatter_add": 0, "ball_query_multi": 0, "gather_smem": 0, "scatter_smem": 0,
        "three_nn_q": 0, "gather_split": 0, "fused_gather_mm": 0,
    }


def test_tensor_on_another_device_raises():
    xyz = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.furthest_point_sample(xyz, 4)


@pytest.mark.parametrize(
    "call",
    [
        lambda x: kernels.fps_kernel.furthest_point_sample_cuda(x, 4),
        lambda x: kernels.ball_query_kernel.ball_query_cuda(0.1, 4, x, x),
        lambda x: kernels.gather_kernel.gather_cuda(x, torch.zeros((1, 2), dtype=torch.int32)),
        lambda x: kernels.three_nn_kernel.three_nn_cuda(x, x),
        lambda x: kernels.ball_query_multi_kernel.ball_query_multi_cuda((0.1, 0.2), (4, 8), x, x),
        lambda x: kernels.gather_smem_kernel.gather_smem_cuda(x, torch.zeros((1, 2), dtype=torch.int32)),
        lambda x: kernels.gather_split_kernel.gather_split_cuda(x, torch.zeros((1, 2), dtype=torch.int32)),
        lambda x: kernels.scatter_smem_kernel.scatter_smem_cuda(torch.zeros((1, 8), dtype=torch.int32), x, 8),
        lambda x: kernels.three_nn_q_kernel.three_nn_q_cuda(x, x),
        lambda x: kernels.fused_gather_mm_kernel.fused_gather_mm_cuda(
            x, torch.zeros((1, 2), dtype=torch.int32), torch.ones((3, 4))),
    ],
    ids=["fps", "ball_query", "gather", "three_nn", "ball_query_multi", "gather_smem", "gather_split",
         "scatter_smem", "three_nn_q", "fused_gather_mm"],
)
def test_cuda_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.zeros((1, 8, 3)))


def test_kernel_modules_name_their_sources_and_tpu_kernels():
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    for k in kernels.KERNELS:
        assert (root / k.SOURCE).is_file(), k.SOURCE
        path, line = k.REPLACES.split(":")
        text = (root / path).read_text().splitlines()
        assert text[int(line) - 1].startswith("def "), k.REPLACES
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-fmad=false" in build.NVCC_FLAGS
    assert build.library_path() == build.library_path()  # content-hashed name
    # j runs i's kernel: its own counter and TPU kernel, three_nn.cu's source
    assert kernels.three_nn_q_kernel.SOURCE == kernels.three_nn_kernel.SOURCE
    assert kernels.three_nn_q_kernel.REPLACES != kernels.three_nn_kernel.REPLACES
    assert not (root / "pointnet2_scannet_tpu_torch/csrc/three_nn_q.cu").exists()
    # b and c share one scan header, which the library's hash covers
    for source in ("ball_query.cu", "ball_query_multi.cu"):
        assert '#include "ball_scan.cuh"' in (build.CSRC / source).read_text()
    assert "ball_scan.cuh" in build.HEADERS


# (B, N, J, C, SMs, (rows, width, tiles, blocks)): gather_smem.cu's tiles and
# persistent grid at P1's five MXU-route gathers (SA1 centroids and
# grouping, SA2 centroids and grouping, SA3 grouping) and bench_gather's
# three shapes, on an H100 SXM (132 SMs) and PCIe (114): as many rows as fit
# 32 KiB, fewer where two tiles a multiprocessor would not be reached; a
# 9001-word row in two chunks
E_PLANS = [
    (32, 8192, 1024, 3, 132, (128, 3, 256, 256)), (32, 8192, 1024, 3, 114, (144, 3, 228, 228)),
    (32, 8192, 32768, 9, 132, (908, 9, 1155, 396)), (32, 8192, 32768, 9, 114, (908, 9, 1155, 342)),
    (32, 1024, 256, 3, 132, (32, 3, 256, 256)), (32, 1024, 256, 3, 114, (36, 3, 228, 228)),
    (32, 1024, 8192, 67, 132, (120, 67, 2185, 396)), (32, 256, 2048, 131, 114, (60, 131, 1093, 342)),
    (32, 8192, 32768, 32, 132, (256, 32, 4096, 396)), (32, 8192, 32768, 64, 114, (128, 64, 8192, 342)),
    (2, 64, 37, 9001, 132, (1, 8192, 148, 148)),
]


@pytest.mark.parametrize("b,n,j,c,sms,want", E_PLANS)
def test_gather_smem_plan(b, n, j, c, sms, want):
    assert tuple(kernels.gather_smem_kernel.plan(b, n, j, c, sms)) == want


# (B, N, J, C, SMs, plan): scatter_smem.cu's route at P1's two train-step
# backwards (SA2, SA3 grouping: little index work a batch row, so the
# accumulate route's (cs, groups)) and at bench_gather's three shapes (the
# sort route's (tile, tiles, walkers, rows, sum_blocks)), for 132 and 114
# SMs; then sort tiles halved until every multiprocessor has one (B = 2, J
# = 131072: 2048 on 114 SMs, 1024 on 132), one ranking warp where n's
# cursors fill shared memory, and P1's SA2 shape at B = 2, where the
# accumulate route would spread over 22 row groups and so sorts
F_PLANS = [
    (32, 1024, 8192, 67, 132, (23, 1)),
    (32, 1024, 8192, 67, 114, (23, 1)),
    (32, 256, 2048, 131, 132, (27, 1)),
    (32, 256, 2048, 131, 114, (27, 1)),
    (32, 8192, 32768, 9, 132, (4096, 8, 4, 16, 2048)),
    (32, 8192, 32768, 32, 114, (4096, 8, 4, 16, 2048)),
    (32, 8192, 32768, 64, 132, (4096, 8, 4, 16, 4096)),
    (2, 16384, 131072, 9, 132, (1024, 128, 2, 8, 512)),
    (2, 16384, 131072, 9, 114, (2048, 64, 2, 8, 512)),
    (1, 65535, 5000, 3, 132, (1024, 5, 1, 16, 512)),
    (2, 1024, 8192, 67, 132, (1024, 8, 8, 1, 768)),
]


@pytest.mark.parametrize("b,n,j,c,sms,want", F_PLANS)
def test_scatter_smem_plan(b, n, j, c, sms, want):
    assert tuple(kernels.scatter_smem_kernel.plan(b, n, j, c, sms)) == want


# (J, N, C) of the gather gradients of the SSG train step (SA2-4 groupings,
# FP0-3 interpolations) and of the MSG train step (SA2 scales 0/1, SA3 and
# SA4 pregather scales 0/1, FP0-3)
H_SHAPES = [
    (8192, 1024, 67), (2048, 256, 131), (512, 64, 259), (24576, 1024, 128), (3072, 256, 256),
    (768, 64, 256), (192, 16, 512),
    (4096, 1024, 99), (8192, 1024, 99), (1024, 256, 128), (2048, 256, 128), (256, 64, 256),
    (512, 64, 256), (24576, 1024, 256), (3072, 256, 512), (768, 64, 512), (192, 16, 1024),
]
# scatter_add.cu's block route (chunks, vec, rows, groups, walkers, page) at
# those shapes, per (B, SMs): the fewest 32-channel chunks a slice that keep
# one block a multiprocessor, 16-byte copies where C % 4 == 0, row groups
# only where batch rows and slices leave multiprocessors idle (B = 2), the
# largest page shared memory holds
H_PLANS = {
    (32, 132): [(1, 1, 1024, 1, 32, 823), (2, 1, 256, 1, 32, 441), (3, 1, 64, 1, 16, 299),
                (1, 4, 1024, 1, 32, 695), (2, 4, 256, 1, 32, 437), (2, 4, 64, 1, 24, 448),
                (4, 4, 16, 1, 6, 192), (1, 1, 1024, 1, 32, 855), (1, 1, 1024, 1, 32, 823),
                (1, 4, 256, 1, 32, 891), (1, 4, 256, 1, 32, 883), (2, 4, 64, 1, 8, 256),
                (2, 4, 64, 1, 16, 449), (2, 4, 1024, 1, 32, 347), (4, 4, 256, 1, 32, 218),
                (4, 4, 64, 1, 24, 224), (4, 4, 16, 1, 6, 192)],
    (32, 114): [(1, 1, 1024, 1, 32, 823), (2, 1, 256, 1, 32, 441), (3, 1, 64, 1, 16, 299),
                (2, 4, 1024, 1, 32, 347), (3, 4, 256, 1, 32, 291), (3, 4, 64, 1, 24, 298),
                (4, 4, 16, 1, 6, 192), (2, 1, 1024, 1, 32, 427), (2, 1, 1024, 1, 32, 411),
                (2, 4, 256, 1, 32, 445), (2, 4, 256, 1, 32, 441), (3, 4, 64, 1, 8, 256),
                (3, 4, 64, 1, 16, 299), (3, 4, 1024, 1, 32, 231), (4, 4, 256, 1, 32, 218),
                (4, 4, 64, 1, 24, 224), (4, 4, 16, 1, 6, 192)],
    (2, 132): [(1, 1, 47, 22, 32, 839), (1, 1, 20, 13, 32, 887), (1, 1, 10, 7, 16, 512),
               (1, 4, 64, 16, 32, 710), (1, 4, 32, 8, 32, 879), (1, 4, 8, 8, 24, 768),
               (1, 4, 4, 4, 6, 192), (1, 1, 64, 16, 32, 870), (1, 1, 64, 16, 32, 838),
               (1, 4, 16, 16, 32, 895), (1, 4, 16, 16, 32, 887), (1, 4, 8, 8, 8, 256),
               (1, 4, 8, 8, 16, 512), (1, 4, 128, 8, 32, 709), (1, 4, 64, 4, 32, 878),
               (1, 4, 16, 4, 24, 768), (1, 4, 8, 2, 6, 192)],
    (2, 114): [(1, 1, 54, 19, 32, 839), (1, 1, 24, 11, 32, 887), (1, 1, 11, 6, 16, 512),
               (1, 4, 74, 14, 32, 710), (1, 4, 37, 7, 32, 879), (1, 4, 10, 7, 24, 768),
               (1, 4, 6, 3, 6, 192), (1, 1, 74, 14, 32, 870), (1, 1, 74, 14, 32, 838),
               (1, 4, 19, 14, 32, 895), (1, 4, 19, 14, 32, 887), (1, 4, 10, 7, 8, 256),
               (1, 4, 10, 7, 16, 512), (1, 4, 147, 7, 32, 709), (1, 4, 86, 3, 32, 878),
               (1, 4, 22, 3, 24, 768), (1, 4, 16, 1, 6, 192)],
}


@pytest.mark.parametrize("b,sms,k", [(b, sms, k) for b, sms in H_PLANS for k in range(len(H_SHAPES))])
def test_scatter_add_plan(b, sms, k):
    j, n, c = H_SHAPES[k]
    p = kernels.scatter_kernel.plan(b, n, j, c, sms)
    assert isinstance(p, kernels.scatter_kernel.BlockPlan)
    assert tuple(p) == H_PLANS[b, sms][k]


@pytest.mark.parametrize("sms", [114, 132])
def test_scatter_add_plan_sorts_over_the_card_past_the_block_route(sms):
    # P3's FP0 (8 columns of 32768 points): J above 65535, so the card-wide
    # sort of csr_sort.cuh, with scatter_smem's sort plan
    sc = kernels.scatter_kernel
    assert sc.plan(8, 1024, 98304, 128, sms) == kernels.scatter_smem_kernel.sort_plan(8, 1024, 98304, 128, sms)
    assert tuple(sc.plan(8, 1024, 98304, 128, sms)) == (1024, 96, 8, 1, 4096)


@pytest.mark.parametrize("sms", [114, 132])
def test_scatter_add_plans_fit_shared_memory(sms):
    sc, ss = kernels.scatter_kernel, kernels.scatter_smem_kernel
    for b in (1, 2, 32):
        for n in (1, 7, 16, 64, 1024, 8192, 32768, sc.MAX_N):
            for j in (0, 1, 192, 24576, 98304):
                for c in (3, 67, 128, 259, 512):
                    p = sc.plan(b, n, j, c, sms)
                    if isinstance(p, sc.BlockPlan):
                        assert j <= sc.MAX_BLOCK_J and 1 <= p.chunks <= sc.MAX_CHUNKS
                        assert p.vec == (4 if c % 4 == 0 else 1)
                        slices = -(-c // (32 * p.chunks))
                        assert (slices - 1) * 32 * p.chunks < c <= slices * 32 * p.chunks
                        assert p.groups * p.rows >= n > (p.groups - 1) * p.rows and p.groups <= 65535
                        assert 1 <= p.walkers <= sc.BLOCK_WARPS and 1 <= p.page <= min(sc.MAX_PAGE, max(j, 1))
                        assert sc.block_bytes(p, j) <= sc.BLOCK_BYTES
                        continue
                    assert j > sc.MAX_BLOCK_J or sc.block_plan(b, n, j, c, sms) is None
                    assert ss.MIN_TILE <= p.tile <= ss.MAX_TILE and p.tile % (32 * p.walkers) == 0
                    assert p.tiles * p.tile >= j > (p.tiles - 1) * p.tile
                    assert 1 <= p.rows <= ss.MAX_ROWS and ss.shared_bytes(p, n) <= ss.SHARED_BYTES


def test_every_included_header_is_in_the_build_hash():
    # the library's name hashes build.SOURCES and build.HEADERS only: a header
    # missing there would leave a stale library after it changes
    import re

    for path in sorted(build.CSRC.glob("*.cu*")):
        for name in re.findall(r'#include "([^"]+)"', path.read_text()):
            assert name in build.HEADERS, (path.name, name)
    assert set(build.HEADERS) == {p.name for p in build.CSRC.glob("*.cuh")}


# (B, N, C, SMs, (cs, groups)): the accumulate route's channel slices (at
# most 32 wide, ragged at C = 67 and 131) and row groups: one row a block,
# ragged groups, groups set by the SM count and by shared memory
@pytest.mark.parametrize("b,n,c,sms,split", [
    (2, 60, 5, 132, (5, 60)), (2, 60, 5, 114, (5, 57)), (3, 300, 9, 132, (9, 44)),
    (2, 1024, 67, 132, (23, 22)), (2, 256, 131, 132, (27, 13)), (1, 12288, 16, 132, (16, 132)),
    (32, 1024, 67, 132, (23, 1)), (32, 8192, 64, 132, (32, 6)),
])
def test_scatter_smem_accumulate_plan(b, n, c, sms, split):
    assert tuple(kernels.scatter_smem_kernel.accumulate_plan(b, n, c, sms)) == split


@pytest.mark.parametrize("sms", [114, 132])
def test_smem_plans_fit_shared_memory(sms):
    gs, ss = kernels.gather_smem_kernel, kernels.scatter_smem_kernel
    for b in (1, 2, 3, 32):
        for n in (1, 7, 60, 300, 1024, 8192, 12288, 32768, ss.MAX_N):
            for j in (1, 37, 1000, 32768):
                for c in (1, 3, 9, 32, 33, 67, 131, 384):
                    p = gs.plan(b, n, j, c, sms)
                    assert p.rows % 4 == 0 and p.width == c
                    assert p.tiles * p.rows >= b * j > (p.tiles - 1) * p.rows
                    assert 1 <= p.blocks <= min(p.tiles, gs.BLOCKS_PER_SM * sms)
                    assert gs.shared_bytes(p) <= gs.SHARED_BYTES
                    a = ss.accumulate_plan(b, n, c, sms)
                    assert a.cs <= 32 and -(-c // a.cs) == -(-c // 32) and 1 <= a.groups <= n
                    assert -(-n // a.groups) * a.cs * 4 <= ss.ACCUMULATE_BYTES
                    q = ss.plan(b, n, j, c, sms)
                    if a.groups * -(-c // a.cs) * j <= ss.ACCUMULATE_WORK:
                        assert q == a
                        continue
                    assert ss.MIN_TILE <= q.tile <= ss.MAX_TILE and q.tile % (32 * q.walkers) == 0
                    assert 1 <= q.walkers <= ss.MAX_WALKERS
                    assert q.tiles * q.tile >= j > (q.tiles - 1) * q.tile
                    assert 1 <= q.rows <= ss.MAX_ROWS
                    assert q.sum_blocks * ss.SUM_THREADS // 32 >= b * -(-n // q.rows) * -(-c // 32)
                    assert ss.shared_bytes(q, n) <= ss.SHARED_BYTES


# (N, J, C) of the row gathers (d) of the SSG forward (the four levels'
# centroids and groupings, FP0-FP3's interpolation) and of the MSG forward
# (SA1 and SA2 groupings, SA3 and SA4 pregather outputs and centred xyz per
# scale, FP0-FP3), all at B = 32
D_SHAPES = [
    (8192, 1024, 3), (1024, 256, 3), (256, 64, 3), (64, 16, 3), (8192, 32768, 9), (1024, 8192, 67),
    (256, 2048, 131), (64, 512, 259), (1024, 24576, 128), (256, 3072, 256), (64, 768, 256),
    (16, 192, 512),
    (8192, 16384, 9), (8192, 32768, 9), (1024, 4096, 99), (1024, 8192, 99), (256, 1024, 128),
    (256, 1024, 3), (256, 2048, 128), (256, 2048, 3), (64, 256, 256), (64, 256, 3), (64, 512, 256),
    (64, 512, 3), (1024, 24576, 256), (256, 3072, 512), (64, 768, 512), (16, 192, 1024),
]
# gather.cu's (vec, per_thread, blocks) there, per SM count: 16-byte words
# where C % 4 == 0, 8 words a thread unless that leaves fewer than two
# blocks a multiprocessor (the centroids, the pregather's xyz)
D_PLANS = {
    132: [(1, 1, 384), (1, 1, 96), (1, 1, 24), (1, 1, 6), (1, 8, 4608), (1, 8, 8576), (1, 8, 4192),
          (1, 8, 2072), (4, 8, 12288), (4, 8, 3072), (4, 8, 768), (4, 8, 384),
          (1, 8, 2304), (1, 8, 4608), (1, 8, 6336), (1, 8, 12672), (4, 8, 512), (1, 1, 384),
          (4, 8, 1024), (1, 2, 384), (4, 4, 512), (1, 1, 96), (4, 8, 512), (1, 1, 192),
          (4, 8, 24576), (4, 8, 6144), (4, 8, 1536), (4, 8, 768)],
    114: [(1, 1, 384), (1, 1, 96), (1, 1, 24), (1, 1, 6), (1, 8, 4608), (1, 8, 8576), (1, 8, 4192),
          (1, 8, 2072), (4, 8, 12288), (4, 8, 3072), (4, 8, 768), (4, 8, 384),
          (1, 8, 2304), (1, 8, 4608), (1, 8, 6336), (1, 8, 12672), (4, 8, 512), (1, 1, 384),
          (4, 8, 1024), (1, 2, 384), (4, 8, 256), (1, 1, 96), (4, 8, 512), (1, 1, 192),
          (4, 8, 24576), (4, 8, 6144), (4, 8, 1536), (4, 8, 768)],
}


@pytest.mark.parametrize("sms,k", [(sms, k) for sms in D_PLANS for k in range(len(D_SHAPES))])
def test_gather_plan(sms, k):
    n, j, c = D_SHAPES[k]
    assert tuple(kernels.gather_kernel.plan(32, n, j, c, sms)) == D_PLANS[sms][k]


@pytest.mark.parametrize("sms", [114, 132])
def test_gather_plans_cover_their_words(sms):
    # each block's tile (per_thread x THREADS words) and its rows' offsets
    # fit the kernel's static shared memory (8 bytes a row, at most a tile
    # plus one rows); the blocks cover the output's words once
    ga = kernels.gather_kernel
    for b in (1, 2, 32):
        for n in (1, 7, 64, 1024, 8192, 65536):
            for j in (1, 37, 1000, 24576, 131072):
                for c in (1, 3, 4, 9, 67, 128, 259, 1024):
                    p = ga.plan(b, n, j, c, sms)
                    assert p.vec == (4 if c % 4 == 0 else 1) and p.per_thread in (1, 2, 4, 8)
                    words, tile = b * j * (c // p.vec), p.per_thread * ga.THREADS
                    assert p.blocks * tile >= words > (p.blocks - 1) * tile
                    if p.per_thread < ga.MAX_PER_THREAD:  # twice as many a thread: too few blocks
                        assert -(-words // (2 * tile)) < 2 * sms
                    assert 8 * (ga.MAX_PER_THREAD * ga.THREADS + 1) <= 48 * 1024


# (N, dtype, (variant, cluster, threads, ppt)): one block up to 16384 float32
# or 8192 float64 points; above, a cluster of 8 blocks with 8 float32 / 4
# float64 points a thread in registers up to 65536 / 32768 points, 16 / 8
# from shared memory past that up to the limits; each boundary's both sides
FPS_PLANS = [
    (64, torch.float32, ("block", 1, 64, 1)), (8192, torch.float32, ("block", 1, 1024, 8)),
    (16384, torch.float32, ("block", 1, 1024, 16)), (16385, torch.float32, ("cluster", 8, 288, 8)),
    (20000, torch.float32, ("cluster", 8, 320, 8)), (32768, torch.float32, ("cluster", 8, 512, 8)),
    (32769, torch.float32, ("cluster", 8, 544, 8)), (65536, torch.float32, ("cluster", 8, 1024, 8)),
    (65537, torch.float32, ("cluster", 8, 544, 16)), (100000, torch.float32, ("cluster", 8, 800, 16)),
    (131072, torch.float32, ("cluster", 8, 1024, 16)),
    (64, torch.float64, ("block", 1, 64, 1)), (8192, torch.float64, ("block", 1, 1024, 8)),
    (8193, torch.float64, ("cluster", 8, 288, 4)), (16384, torch.float64, ("cluster", 8, 512, 4)),
    (20000, torch.float64, ("cluster", 8, 640, 4)), (32768, torch.float64, ("cluster", 8, 1024, 4)),
    (32769, torch.float64, ("cluster", 8, 544, 8)), (65536, torch.float64, ("cluster", 8, 1024, 8)),
]


@pytest.mark.parametrize("n,dtype,want", FPS_PLANS)
def test_fps_plan(n, dtype, want):
    fk = kernels.fps_kernel
    p = fk.plan(n, dtype)
    assert tuple(p) == want
    share = -(-n // p.cluster)
    assert p.threads * p.ppt >= share > p.threads * p.ppt - 32 * p.ppt
    # the share fits a block's shared memory; a cluster thread's points fit
    # its registers, or the row is past what registers hold in MAX_CLUSTER
    assert 12 * share * (dtype.itemsize // 4) <= 192 * 1024
    if p.variant == "cluster":
        regs = fk.REG_POINTS[dtype]
        assert p.ppt == regs or (p.ppt == 2 * regs and n > fk.MAX_CLUSTER * fk.MAX_THREADS * regs)
        assert p in fk.candidate_plans(n, dtype)


@pytest.mark.parametrize("n,dtype", [(131073, torch.float32), (65537, torch.float64), (0, torch.float32)])
def test_fps_plan_refuses_rows_past_its_limit(n, dtype):
    limit = kernels.fps_kernel.MAX_CLUSTER * kernels.fps_kernel.BLOCK_POINTS[dtype]
    with pytest.raises(ValueError, match=f"N <= {limit}"):
        kernels.fps_kernel.plan(n, dtype)


def test_every_c_entry_point_matches_its_ctypes_signature():
    # ctypes passes exactly the arguments build._SIGNATURES lists: one too
    # few or too many there shows only on the card, as a TypeError or as
    # arguments shifted by one
    import re

    sources = "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    for name, argtypes in build._SIGNATURES.items():
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', sources)
        assert found, name
        assert len(found.group(1).split(",")) == len(argtypes), name


# (B, n or N, m or M) at which chip_smoke.py runs 3-NN (i) and the ball
# query (b): SSG's and MSG's levels at 32 columns, P2's FP0 and SA1 at 8000
# and 7936 points (7936's FP0 goes to the query-major kernel), P3's levels
# at 8 x 32768, whole-scene micro-batches of 16 and 2 columns, the card vs
# CPU check at 2 x 32768, and (i only) n = m = 8192, j's counterpart
QUERY_SHAPES = [
    (32, 8192, 1024), (32, 1024, 256), (32, 256, 64), (32, 64, 16), (32, 8000, 1024), (32, 7936, 1024),
    (8, 32768, 1024), (8, 1024, 256), (8, 256, 64), (8, 64, 16), (16, 8192, 1024), (2, 8192, 1024),
    (2, 32768, 1024),
]
I_SHAPES = QUERY_SHAPES + [(32, 8192, 8192)]
# three_nn.cu's (points a thread, threads a block, blocks a batch row) per
# SM count: 4 points a thread at the full-width FP0, fewer and smaller
# blocks at the deep levels so that they still cover the multiprocessors
I_PLANS = {
    132: [(4, 256, 8), (1, 128, 8), (1, 64, 4), (1, 64, 1), (4, 256, 8), (4, 256, 8), (4, 256, 32),
          (1, 64, 16), (1, 64, 4), (1, 64, 1), (2, 256, 16), (1, 64, 128), (1, 256, 128), (4, 256, 8)],
    114: [(4, 256, 8), (1, 256, 4), (1, 64, 4), (1, 64, 1), (4, 256, 8), (4, 256, 8), (4, 256, 32),
          (1, 64, 16), (1, 64, 4), (1, 64, 1), (4, 256, 8), (1, 128, 64), (2, 256, 64), (4, 256, 8)],
}
# ball_query.cu's (route, tile, warps, queries a block, blocks a batch row):
# the row whole in shared memory up to 16384 points (padded to 128), tiles
# of 4096 past it; blocks that fill the card twice, one query a warp at least
B_PLANS = {
    132: [("resident", 8192, 32, 64, 16), ("resident", 1024, 32, 32, 8), ("resident", 256, 32, 32, 2),
          ("resident", 128, 32, 16, 1), ("resident", 8064, 32, 64, 16), ("resident", 7936, 32, 64, 16),
          ("tiled", 4096, 32, 32, 32), ("resident", 1024, 32, 32, 8), ("resident", 256, 32, 32, 2),
          ("resident", 128, 32, 16, 1), ("resident", 8192, 32, 32, 32), ("resident", 8192, 32, 32, 32),
          ("tiled", 4096, 32, 32, 32)],
    114: [("resident", 8192, 32, 74, 14), ("resident", 1024, 32, 32, 8), ("resident", 256, 32, 32, 2),
          ("resident", 128, 32, 16, 1), ("resident", 8064, 32, 74, 14), ("resident", 7936, 32, 74, 14),
          ("tiled", 4096, 32, 32, 32), ("resident", 1024, 32, 32, 8), ("resident", 256, 32, 32, 2),
          ("resident", 128, 32, 16, 1), ("resident", 8192, 32, 37, 28), ("resident", 8192, 32, 32, 32),
          ("tiled", 4096, 32, 32, 32)],
}


@pytest.mark.parametrize("sms,k", [(sms, k) for sms in I_PLANS for k in range(len(I_SHAPES))])
def test_three_nn_plan(sms, k):
    assert tuple(kernels.three_nn_kernel.plan(*I_SHAPES[k], sms)) == I_PLANS[sms][k]


@pytest.mark.parametrize("sms,k", [(sms, k) for sms in B_PLANS for k in range(len(QUERY_SHAPES))])
def test_ball_query_plan(sms, k):
    assert tuple(kernels.ball_query_kernel.plan(*QUERY_SHAPES[k], sms)) == B_PLANS[sms][k]


# (B, N, M) of the two-radius query (c): MSG's four levels at 32 columns, the
# whole-scene micro-batches of 16 and 2 columns, and rows past 16384 points
# (the tiled route): P3's SA1 at 8 x 32768 and one row of 20000
C_SHAPES = [(32, 8192, 1024), (32, 1024, 256), (32, 256, 64), (32, 64, 16), (16, 8192, 1024),
            (2, 8192, 1024), (8, 32768, 1024), (1, 20000, 256)]
# ball_query_multi.cu's (route, tile, warps, queries a block, blocks a batch
# row): b's rule, the tiled route's counts for both rows in shared memory
C_PLANS = {
    132: [("resident", 8192, 32, 64, 16), ("resident", 1024, 32, 32, 8), ("resident", 256, 32, 32, 2),
          ("resident", 128, 32, 16, 1), ("resident", 8192, 32, 32, 32), ("resident", 8192, 32, 32, 32),
          ("tiled", 4096, 32, 32, 32), ("tiled", 4096, 32, 32, 8)],
    114: [("resident", 8192, 32, 74, 14), ("resident", 1024, 32, 32, 8), ("resident", 256, 32, 32, 2),
          ("resident", 128, 32, 16, 1), ("resident", 8192, 32, 37, 28), ("resident", 8192, 32, 32, 32),
          ("tiled", 4096, 32, 32, 32), ("tiled", 4096, 32, 32, 8)],
}


@pytest.mark.parametrize("sms,k", [(sms, k) for sms in C_PLANS for k in range(len(C_SHAPES))])
def test_ball_query_multi_plan(sms, k):
    bq, bqm = kernels.ball_query_kernel, kernels.ball_query_multi_kernel
    p = bqm.plan(*C_SHAPES[k], sms)
    assert tuple(p) == C_PLANS[sms][k]
    assert tuple(p) == tuple(bq.plan(*C_SHAPES[k], sms))  # b's launch where the shapes agree
    assert bq.shared_bytes(p, bqm.RADII) <= 232448  # a block's limit on the H100
    assert bq.shared_bytes(p, bqm.RADII) + bq.BLOCK_RESERVED <= bq.SM_SHARED


class _FakeLibrary:
    """Stands in for the kernel library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors pass the wrappers' device checks on a card of 132
    multiprocessors whose C entry points only record their arguments."""
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    monkeypatch.setattr(build, "sm_count", lambda t: 132)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    kernels.reset_launch_counts()
    return lib


@pytest.mark.parametrize("radii,nsamples", [((0.05, 0.1), (16, 32)), ((0.1, 0.05), (32, 16))])
def test_ball_query_multi_wrapper_launches_its_plan(fake_card, radii, nsamples):
    bqm = kernels.ball_query_multi_kernel
    xyz = torch.zeros((2, 8192, 3))
    q = torch.zeros((2, 1024, 3))
    outs = bqm.ball_query_multi_cuda(radii, nsamples, xyz, q)
    assert [tuple(o.shape) for o in outs] == [(2, 1024, k) for k in nsamples]
    [(name, args)] = fake_card.calls
    p = bqm.plan(2, 8192, 1024, 132)
    assert name == "p2_ball_query_multi"
    # the radii in the caller's order (the entry point puts the wider first)
    assert args[2:13] == (2, 8192, 1024, *(x for pair in zip(radii, nsamples) for x in pair),
                          int(p.route == "tiled"), p.tile, p.warps, p.per_block)
    assert kernels.launch_counts()["ball_query_multi"] == 1
    assert kernels.launch_counts()["ball_query"] == 0


def test_three_nn_q_wrapper_runs_i_kernel_with_i_plan(fake_card):
    nn3, nnq = kernels.three_nn_kernel, kernels.three_nn_q_kernel
    for b, n, m in ((32, 7936, 1024), (2, 8192, 8192), (1, 256, 8192)):
        nnq.three_nn_q_cuda(torch.zeros((b, n, 3)), torch.zeros((b, m, 3)))
        name, args = fake_card.calls[-1]
        p = nn3.plan(b, n, m, 132)
        assert name == "p2_three_nn" and args[2:7] == (b, n, m, p.per_thread, p.threads)
    # j's launches stay j's
    assert kernels.launch_counts()["three_nn_q"] == 3
    assert kernels.launch_counts()["three_nn"] == 0


def test_batch_limit_refuses_65536_rows_and_takes_65535():
    assert build.MAX_BATCH == 65535
    build.check_batch(65535, "ball_query")
    with pytest.raises(ValueError, match="at most 65535 rows, got B = 65536"):
        build.check_batch(65536, "ball_query")


BATCH_LIMITED = {
    "ball_query": lambda x, i: kernels.ball_query_kernel.ball_query_cuda(0.1, 4, x, x),
    "ball_query_multi": lambda x, i: kernels.ball_query_multi_kernel.ball_query_multi_cuda(
        (0.1, 0.2), (4, 8), x, x),
    "three_nn": lambda x, i: kernels.three_nn_kernel.three_nn_cuda(x, x.expand(-1, 3, -1)),
    "three_nn_q": lambda x, i: kernels.three_nn_q_kernel.three_nn_q_cuda(x, x.expand(-1, 3, -1)),
    "scatter_add": lambda x, i: kernels.scatter_kernel.scatter_add_cuda(i, x, 1),
    "scatter_smem": lambda x, i: kernels.scatter_smem_kernel.scatter_smem_cuda(i, x, 1),
}


@pytest.mark.parametrize("name", BATCH_LIMITED)
def test_wrappers_refuse_a_batch_past_the_limit_before_launching(fake_card, name):
    x, i = torch.zeros((65536, 1, 3)), torch.zeros((65536, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{name} takes a batch of at most 65535"):
        BATCH_LIMITED[name](x, i)
    assert fake_card.calls == []
    BATCH_LIMITED[name](x[:65535], i[:65535])  # the limit itself launches
    assert len(fake_card.calls) == 1


SWEEP = (1, 3, 64, 100, 1024, 8000, 16384, 16385, 20000, 32768, 65536)


@pytest.mark.parametrize("sms", [114, 132])
def test_three_nn_plans_cover_their_queries(sms):
    # the blocks of a row cover its n unknown points once, with a block
    # size three_nn.cu takes
    nn = kernels.three_nn_kernel
    for b in (1, 2, 8, 32):
        for n in SWEEP:
            for m in (3, 16, 1024, 2500, 65536):
                p = nn.plan(b, n, m, sms)
                assert p.per_thread in nn.PER_THREAD and p.threads in nn.THREADS
                per_block = p.per_thread * p.threads
                assert p.blocks * per_block >= n > (p.blocks - 1) * per_block


@pytest.mark.parametrize("sms", [114, 132])
def test_ball_query_plans_fit_shared_memory(sms):
    # every plan's block fits a multiprocessor's shared memory (static
    # arrays and the card's reserve included), its tile holds whole steps of
    # 128 points (the resident one the whole row), the tiled route's counts
    # fit their static arrays, and the blocks of a row cover its queries once
    bq = kernels.ball_query_kernel
    for b in (1, 2, 8, 32):
        for n in SWEEP:
            for m in SWEEP:
                p = bq.plan(b, n, m, sms)
                assert tuple(kernels.ball_query_multi_kernel.plan(b, n, m, sms)) == tuple(p)
                assert p.route == ("resident" if n <= bq.RESIDENT_POINTS else "tiled")
                assert p.tile % bq.STEP == 0 and (p.route == "tiled" or p.tile >= n)
                assert bq.shared_bytes(p) + bq.BLOCK_RESERVED <= bq.SM_SHARED
                assert bq.shared_bytes(p) <= 232448  # a block's limit on the H100
                assert p.warps * 32 <= 1024
                assert p.route == "resident" or p.per_block <= bq.MAX_TILED_QUERIES
                assert p.blocks * p.per_block >= m > (p.blocks - 1) * p.per_block
