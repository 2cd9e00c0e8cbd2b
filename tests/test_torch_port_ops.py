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
    centroids.sum().backward()  # the gather's backward: the plain scatter-add
    assert xyz.grad is not None
    assert kernels.launch_counts() == {
        "furthest_point_sample": 0, "ball_query": 0, "gather": 0, "three_nn": 0,
        "scatter_add": 0, "ball_query_multi": 0,
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
    ],
    ids=["fps", "ball_query", "gather", "three_nn", "ball_query_multi"],
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
