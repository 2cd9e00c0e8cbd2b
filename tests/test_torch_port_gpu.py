"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `gpu`: each test skips without a CUDA device. This file imports
neither jax nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -m gpu

Indices, gathers, squared distances and scatter-adds must be equal bit for
bit (the scatter-add against the plain version on CPU copies: the plain
version's CUDA atomics add in no fixed order), and the two-radius ball query
equals two single-radius launches. Small SSG and MSG models on the card
match the CPU to float32 matmul order; an SSG and an MSG train step on the
card match one on the CPU and repeat bit for bit.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, PointNet2Spec
from pointnet2_scannet_tpu_torch.ops import cuda as kernels
from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel as bq,
    ball_query_multi_kernel as bqm,
    fps_kernel as fps,
    gather_kernel as ga,
    scatter_kernel as sc,
    three_nn_kernel as nn3,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(seed, shape, dev, lo=0.0, hi=1.5):
    a = np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())


# (N, npoint, dtype): one block a row up to 16384 float32 / 8192 float64
# points, a cluster of 8 blocks a row above (fps_kernel.plan): points in
# registers up to 65536 float32 / 32768 float64 at several block widths,
# ragged shares included, and from shared memory past that up to the limits,
# 131072 and 65536; SSG's four levels (8192, 1024, 256 and 64 points in)
FPS_SHAPES = [
    (64, 16, torch.float32), (256, 64, torch.float32), (200, 50, torch.float32), (1024, 256, torch.float32),
    (8192, 1024, torch.float32), (16384, 512, torch.float32), (16385, 256, torch.float32),
    (20000, 256, torch.float32), (32768, 256, torch.float32), (40000, 128, torch.float32),
    (45000, 128, torch.float32), (50000, 128, torch.float32), (65536, 128, torch.float32),
    (65537, 64, torch.float32), (131072, 32, torch.float32),
    (200, 50, torch.float64), (8192, 256, torch.float64), (8193, 128, torch.float64),
    (12289, 128, torch.float64), (20000, 128, torch.float64), (22000, 64, torch.float64),
    (26000, 64, torch.float64), (32768, 64, torch.float64), (32769, 32, torch.float64),
    (65536, 32, torch.float64),
]


@pytest.mark.parametrize("n,npoint,dtype", FPS_SHAPES)
@pytest.mark.parametrize("skip", [True, False])
def test_fps_kernel_equals_plain(dev, n, npoint, dtype, skip):
    xyz = _cloud(n, (2, n, 3), dev).to(dtype)
    xyz[0, 3] = 0.0  # near the origin
    xyz[1, n // 2:] = xyz[1, : n - n // 2].clone()  # duplicates: exact ties
    before = fps.launches
    variant = fps.plan(n, dtype).variant
    count = fps.variant_launches[variant]
    _equal(fps.furthest_point_sample_cuda(xyz, npoint, skip_near_origin=skip),
           fps.furthest_point_sample_plain(xyz, npoint, skip_near_origin=skip))
    assert fps.launches == before + 1
    assert fps.variant_launches[variant] == count + 1


@pytest.mark.parametrize("n,dtype", [(20000, torch.float32), (20000, torch.float64)])
def test_fps_every_candidate_plan_equals_plain(dev, n, dtype):
    # every cluster size that holds the row, points in registers (float32:
    # 3-8 blocks, float64: 5-8) or from shared memory (2-8, 3-8): the
    # launches profile_scatter --routes times
    xyz = _cloud(n, (2, n, 3), dev).to(dtype)
    xyz[1, n // 2:] = xyz[1, : n - n // 2].clone()
    want = fps.furthest_point_sample_plain(xyz, 64)
    plans = fps.candidate_plans(n, dtype)
    assert fps.plan(n, dtype) in plans
    for p in plans:
        _equal(fps.launch(xyz, 64, p), want)


@pytest.mark.parametrize("n,dtype", [(32768, torch.float32), (65537, torch.float32), (20000, torch.float64)])
@pytest.mark.parametrize("skip", [True, False])
def test_fps_cluster_tie_across_blocks_goes_to_the_lower_index(dev, n, dtype, skip):
    # block 0 holds points near its first one; blocks 1.. each hold the same
    # 64 far points at other places of their shares, so each step's largest
    # min-distance ties across blocks and block 1's copy (the lowest global
    # index) must win
    p = fps.plan(n, dtype)
    assert p.variant == "cluster" and p.cluster >= 3
    share = -(-n // p.cluster)
    rng = np.random.default_rng(n)
    far = rng.uniform(1.0, 2.0, size=(64, 3))
    xyz = rng.uniform(0.0, 0.01, size=(2, n, 3))
    for r in range(1, p.cluster):
        count = min(share, n - r * share)
        xyz[:, r * share + rng.permutation(count)[:64]] = far
    xyz = torch.from_numpy(xyz).to(dev, dtype)
    got = fps.furthest_point_sample_cuda(xyz, 48, skip_near_origin=skip)
    _equal(got, fps.furthest_point_sample_plain(xyz, 48, skip_near_origin=skip))
    assert bool(((got[:, 1:] >= share) & (got[:, 1:] < 2 * share)).all())


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_fps_kernel_computes_half_precision_in_float32(dev, dtype):
    xyz = _cloud(7, (2, 20000, 3), dev).to(dtype)
    got = fps.furthest_point_sample_cuda(xyz, 128)
    _equal(got, fps.furthest_point_sample_plain(xyz, 128))
    _equal(got, fps.furthest_point_sample_cuda(xyz.float(), 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fps_kernel_refuses_too_many_points(dev, dtype):
    limit = fps.MAX_CLUSTER * fps.BLOCK_POINTS[dtype]
    with pytest.raises(ValueError, match=f"N <= {limit}"):
        fps.furthest_point_sample_cuda(torch.zeros((1, limit + 1, 3), dtype=dtype, device=dev), 4)


@pytest.mark.parametrize(
    "radius,nsample,n,m", [(0.1, 32, 8192, 1024), (0.2, 32, 1024, 256), (0.4, 32, 256, 64),
                           (0.8, 32, 64, 16), (2.0, 40, 16, 5), (0.05, 8, 300, 77)]
)
def test_ball_query_kernel_equals_plain(dev, radius, nsample, n, m):
    xyz = _cloud(n + m, (3, n, 3), dev)
    q = xyz[:, :m].contiguous()
    q[0, 0] = 10.0  # an empty ball: all zeros
    _equal(bq.ball_query_cuda(radius, nsample, xyz, q), bq.ball_query_plain(radius, nsample, xyz, q))


def test_ball_query_kernel_radius_boundary(dev):
    r = np.float32(0.25)
    xyz = torch.full((1, 64, 3), 3.0, device=dev)
    xyz[0, 3] = torch.tensor([float(r), 0.0, 0.0])
    xyz[0, 4] = torch.tensor([float(np.nextafter(r, np.float32(0))), 0.0, 0.0])
    q = torch.zeros((1, 1, 3), device=dev)
    got = bq.ball_query_cuda(0.25, 4, xyz, q)
    assert got.cpu().tolist() == [[[4, 4, 4, 4]]]
    _equal(got, bq.ball_query_plain(0.25, 4, xyz, q))


def _multi_equal(radii, nsamples, xyz, q, got=None):
    got = bqm.ball_query_multi_cuda(radii, nsamples, xyz, q) if got is None else got
    for g, w, r, k in zip(got, bqm.ball_query_multi_plain(radii, nsamples, xyz, q), radii, nsamples):
        _equal(g, w)
        _equal(g, bq.ball_query_cuda(r, k, xyz, q))


# (radii, nsamples, N, M, side of the cloud): MSG's four levels, small and
# ragged shapes; then dense clouds (rows fill): MSG SA1's radii in both
# orders on the resident route (8192) and the tiled one (20000, 32768),
# equal radii, nsample past the hits (short rows) and past N, one nsample 0
@pytest.mark.parametrize(
    "radii,nsamples,n,m,side",
    [((0.05, 0.1), (16, 32), 8192, 1024, 1.5), ((0.1, 0.2), (16, 32), 1024, 256, 1.5),
     ((0.2, 0.4), (16, 32), 256, 64, 1.5), ((0.4, 0.8), (16, 32), 64, 16, 1.5),
     ((0.5, 0.15), (40, 8), 300, 77, 1.5), ((2.0, 0.3), (24, 33), 16, 5, 1.5),
     ((0.05, 0.1), (16, 32), 8192, 1024, 0.6), ((0.1, 0.05), (32, 16), 8192, 1024, 0.6),
     ((0.05, 0.1), (16, 32), 20000, 300, 0.6), ((0.1, 0.05), (32, 16), 32768, 200, 0.6),
     ((0.1, 0.1), (8, 40), 300, 50, 0.6), ((2.0, 0.05), (128, 64), 100, 13, 0.6),
     ((3.0, 0.02), (30000, 5), 20000, 9, 0.6), ((0.05, 0.1), (0, 32), 8192, 64, 0.6)],
)
def test_ball_query_multi_kernel_equals_plain_and_two_single_queries(dev, radii, nsamples, n, m, side):
    xyz = _cloud(n + m + 1, (3, n, 3), dev, hi=side)
    q = xyz[:, :m].contiguous()
    q[0, 0] = 10.0  # an empty ball: all zeros in both rows
    xyz[2, n // 2:] = xyz[2, : n - n // 2].clone()  # duplicates
    assert bqm.plan(3, n, m, 132).route == ("resident" if n <= bq.RESIDENT_POINTS else "tiled")
    before = bqm.launches
    _multi_equal(radii, nsamples, xyz, q)
    assert bqm.launches == before + 1


def test_ball_query_multi_kernel_radius_boundary(dev):
    r1, r2 = np.float32(0.25), np.float32(0.5)
    xyz = torch.full((1, 64, 3), 3.0, device=dev)
    xyz[0, 3] = torch.tensor([float(r1), 0.0, 0.0])
    xyz[0, 4] = torch.tensor([float(np.nextafter(r1, np.float32(0))), 0.0, 0.0])
    xyz[0, 7] = torch.tensor([float(r2), 0.0, 0.0])
    q = torch.zeros((1, 1, 3), device=dev)
    got = bqm.ball_query_multi_cuda((0.5, 0.25), (6, 4), xyz, q)
    assert got[0].cpu().tolist() == [[[3, 4, 3, 3, 3, 3]]]
    assert got[1].cpu().tolist() == [[[4, 4, 4, 4]]]
    for g, w in zip(got, bqm.ball_query_multi_plain((0.5, 0.25), (6, 4), xyz, q)):
        _equal(g, w)


@pytest.mark.parametrize("radii,nsamples", [((0.05, 0.1), (16, 32)), ((0.1, 0.05), (32, 16))])
def test_ball_query_multi_kernel_launch_shapes_equal_plain(dev, radii, nsamples):
    # every launch shape candidate_plans() lists, and the tiled route forced
    # with tiles of 128 and 384 points, whose boundaries the repeated points
    # straddle (ties between a tile's points and the next tile's)
    n, m = 2000, 200
    xyz = _cloud(11, (2, n, 3), dev, hi=0.3)
    xyz[:, 384:768] = xyz[:, :384].clone()
    xyz[:, 1000:1130] = xyz[:, 120:250].clone()
    q = xyz[:, 100:100 + m].contiguous()
    want = bqm.ball_query_multi_plain(radii, nsamples, xyz, q)
    plans = bqm.candidate_plans(2, n, m, 132) + [
        bq.Plan("tiled", tile, warps, per_block, -(-m // per_block))
        for tile in (128, 384) for warps, per_block in ((8, 32), (32, 200))]
    for p in plans:
        outs = tuple(torch.empty_like(w) for w in want)
        got = bqm.launch(radii, nsamples, xyz, q, outs, p)
        for g, w in zip(got, want):
            _equal(g, w)
    _multi_equal(radii, nsamples, xyz, q, got)


@pytest.mark.parametrize("n,at", [(64, 3), (20000, 4100), (32768, 20000)])
@pytest.mark.parametrize("order", [1, -1])
def test_ball_query_multi_kernel_radius_boundary_on_each_route(dev, n, at, order):
    # at each radius a point at exactly r misses and one an ulp inside hits
    # (on the tiled route in a tile past the first), radii in both orders
    r1, r2 = np.float32(0.25), np.float32(0.5)
    xyz = torch.full((1, n, 3), 3.0, device=dev)
    for k, x in enumerate((r1, np.nextafter(r1, np.float32(0)), r2, np.nextafter(r2, np.float32(0)))):
        xyz[0, at + k] = torch.tensor([float(x), 0.0, 0.0])
    q = torch.zeros((1, 1, 3), device=dev)
    radii, nsamples = (0.5, 0.25)[::order], (6, 4)[::order]
    got = bqm.ball_query_multi_cuda(radii, nsamples, xyz, q)
    wide, narrow = got[::order]
    assert wide.cpu().tolist() == [[[at, at + 1, at + 3, at, at, at]]]
    assert narrow.cpu().tolist() == [[[at + 1] * 4]]
    _multi_equal(radii, nsamples, xyz, q, got)


BATCH_LIMITED = {
    "ball_query": lambda x, i: bq.ball_query_cuda(0.1, 4, x, x),
    "ball_query_multi": lambda x, i: bqm.ball_query_multi_cuda((0.1, 0.2), (4, 8), x, x),
    "three_nn": lambda x, i: nn3.three_nn_cuda(x, x.expand(-1, 3, -1).contiguous()),
    "three_nn_q": lambda x, i: kernels.three_nn_q_kernel.three_nn_q_cuda(x, x.expand(-1, 3, -1).contiguous()),
    "scatter_add": lambda x, i: sc.scatter_add_cuda(i, x, 1),
    "scatter_smem": lambda x, i: kernels.scatter_smem_kernel.scatter_smem_cuda(i, x, 1),
}


@pytest.mark.parametrize("name", BATCH_LIMITED)
def test_wrappers_refuse_a_batch_past_the_grid_limit(dev, name):
    # B = 65536 rows of one point: a ValueError naming the limit, before any
    # launch; 65535 rows launch
    x, i = torch.zeros((65536, 1, 3), device=dev), torch.zeros((65536, 1), dtype=torch.int32, device=dev)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match=f"{name} takes a batch of at most 65535 rows"):
        BATCH_LIMITED[name](x, i)
    assert kernels.launch_counts() == before
    BATCH_LIMITED[name](x[:65535], i[:65535])
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before[name] + 1


@pytest.mark.parametrize("c", [3, 9, 67, 128, 131, 259, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_kernel_equals_plain(dev, c, dtype):
    g = torch.Generator(device=dev).manual_seed(c)
    if dtype == torch.float32:
        src = torch.randn((2, 300, c), generator=g, device=dev)
    else:
        src = torch.randint(-2**31, 2**31 - 1, (2, 300, c), generator=g, device=dev, dtype=dtype)
    idx = torch.randint(0, 300, (2, 1000), generator=g, device=dev, dtype=torch.int32)
    _equal(ga.gather_cuda(src, idx), ga.gather_plain(src, idx))


# (B, N, J, C): J not a multiple of a tile (8 x 256 words), one batch row,
# one source row, one index, 16-byte and 4-byte words
GATHER_EDGE_SHAPES = [(3, 50, 1001, 128), (3, 50, 1001, 9), (1, 300, 777, 67), (2, 1, 513, 4),
                      (2, 1, 7, 3), (1, 5, 1, 256)]


@pytest.mark.parametrize("b,n,j,c", GATHER_EDGE_SHAPES)
def test_gather_kernel_takes_ragged_and_tiny_shapes(dev, b, n, j, c):
    g = torch.Generator(device=dev).manual_seed(j)
    src = torch.randn((b, n, c), generator=g, device=dev)
    idx = torch.randint(0, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    _equal(ga.gather_cuda(src, idx), ga.gather_plain(src, idx))


@pytest.mark.parametrize("c", [128, 67])
def test_gather_kernel_routes_equal_plain(dev, c):
    # every words-a-thread choice, 16-byte words where C allows them
    g = torch.Generator(device=dev).manual_seed(c)
    src = torch.randn((3, 257, c), generator=g, device=dev)
    idx = torch.randint(0, 257, (3, 1234), generator=g, device=dev, dtype=torch.int32)
    want = ga.gather_plain(src, idx)
    for vec in sorted({ga.plan(3, 257, 1234, c, 132).vec, 1}):
        for per in (1, 2, 4, 8):
            p = ga.Plan(vec, per, -(-3 * 1234 * (c // vec) // (per * ga.THREADS)))
            before = ga.launches
            _equal(ga.launch(src, idx, torch.empty_like(want), p), want)
            assert ga.launches == before + 1


@pytest.mark.parametrize("where", ["src", "out"])
def test_gather_kernel_takes_pointers_off_16_byte_alignment(dev, where):
    g = torch.Generator(device=dev).manual_seed(5)
    b, n, j, c = 2, 300, 1000, 128
    src = torch.randn((b, n, c), generator=g, device=dev)
    idx = torch.randint(0, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    want = ga.gather_plain(src, idx)
    out = torch.empty((b, j, c), device=dev)
    if where == "src":  # a contiguous view one word into its storage
        src = torch.cat([torch.zeros(1, device=dev), src.reshape(-1)])[1:].view(b, n, c)
        assert src.is_contiguous() and src.data_ptr() % 16 == 4
    else:
        out = torch.empty(b * j * c + 1, device=dev)[1:].view(b, j, c)
    _equal(ga.launch(src, idx, out, ga.plan(b, n, j, c, 132)), want)


@pytest.mark.parametrize("c", [3, 128])
def test_gather_kernel_moves_raw_words(dev, c):
    # -0.0, inf, -inf and NaN bit patterns (a quiet and a signalling NaN with
    # payloads) come through unchanged, as float32 and as int32 words
    words = torch.tensor([0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0x7F800001, 0xFFFFFFFF,
                          0x00000001, 0x3F800000], dtype=torch.int64)
    words = (words - (words >= 2**31).long() * 2**32).to(torch.int32)
    src = words.repeat(2 * 40 * c // 8 + 1)[: 2 * 40 * c].view(2, 40, c).to(dev)
    idx = torch.randint(0, 40, (2, 333), device=dev, dtype=torch.int32)
    _equal(ga.gather_cuda(src, idx), ga.gather_plain(src, idx))
    got = ga.gather_cuda(src.view(torch.float32), idx)
    _equal(got.view(torch.int32), ga.gather_plain(src, idx))


def test_gather_kernel_is_forward_only(dev):
    # the wrapper launches the forward alone; ops.gather_points carries the
    # gradient (scatter_add.cu)
    src = torch.zeros((1, 8, 3), device=dev, requires_grad=True)
    out = ga.gather_cuda(src.detach(), torch.zeros((1, 2), dtype=torch.int32, device=dev))
    assert not out.requires_grad and out.grad_fn is None
    with pytest.raises(TypeError):
        ga.gather_cuda(torch.zeros((1, 8, 3), dtype=torch.float64, device=dev),
                       torch.zeros((1, 2), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("n,m", [(8192, 1024), (1024, 256), (256, 64), (64, 16), (300, 2500), (7, 3)])
def test_three_nn_kernel_equals_plain(dev, n, m):
    unknown = _cloud(n, (2, n, 3), dev)
    known = _cloud(m + 1, (2, m, 3), dev)
    known[1, m // 2:] = known[1, : m - m // 2].clone()  # duplicates: exact ties
    got, want = nn3.three_nn_cuda(unknown, known), nn3.three_nn_plain(unknown, known)
    _equal(got[0], want[0])
    _equal(got[1], want[1])



def _three_nn_equal(unknown, known, got=None):
    want = nn3.three_nn_plain(unknown, known)
    got = nn3.three_nn_cuda(unknown, known) if got is None else got
    _equal(got[0], want[0])
    _equal(got[1], want[1])


# (B, n, m): n not a multiple of any thread's points times its block, m
# past one tile (1024 known points) and not a multiple of it
@pytest.mark.parametrize("b,n,m", [(2, 1000, 300), (3, 777, 2500), (1, 1537, 20000)])
def test_three_nn_kernel_launch_shapes_equal_plain(dev, b, n, m):
    # every launch shape (points a thread, threads a block) that plan() can
    # pick, with exact ties: known points repeated across the tile boundary,
    # unknown points repeated within a thread's and across threads' queries
    unknown = _cloud(n, (b, n, 3), dev)
    unknown[:, 1::2] = unknown[:, : n // 2].clone()
    known = _cloud(m + 7, (b, m, 3), dev)
    if m > 1024:
        known[:, 1024: 1024 + min(1024, m - 1024)] = known[:, : min(1024, m - 1024)].clone()
    for p in nn3.candidate_plans(b, n, m):
        before = nn3.launches
        out = (torch.empty((b, n, 3), device=dev), torch.empty((b, n, 3), dtype=torch.int32, device=dev))
        _three_nn_equal(unknown, known, nn3.launch(unknown, known, *out, p))
        assert nn3.launches == before, p  # launch() counts none: three_nn_cuda and j's wrapper do


def test_three_nn_kernel_takes_one_unknown_and_three_known(dev):
    unknown = _cloud(1, (1, 1, 3), dev)
    known = _cloud(2, (1, 3, 3), dev)
    _three_nn_equal(unknown, known)


def test_three_nn_kernel_on_an_all_zero_row(dev):
    # a padded row of whole-scene training: every distance ties at 0
    unknown = _cloud(3, (2, 300, 3), dev)
    known = _cloud(4, (2, 70, 3), dev)
    unknown[1] = 0.0
    known[1] = 0.0
    dist2, idx = nn3.three_nn_cuda(unknown, known)
    assert idx[1].cpu().tolist() == [[0, 1, 2]] * 300 and float(dist2[1].abs().max()) == 0.0
    _three_nn_equal(unknown, known)


@pytest.mark.parametrize("where", ["unknown", "known"])
def test_three_nn_kernel_takes_pointers_off_16_byte_alignment(dev, where):
    unknown = _cloud(5, (2, 500, 3), dev)
    known = _cloud(6, (2, 1100, 3), dev)
    t = unknown if where == "unknown" else known
    view = torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    if where == "unknown":
        unknown = view
    else:
        known = view
    _three_nn_equal(unknown, known)


def _ball_query_equal(radius, nsample, xyz, q):
    _equal(bq.ball_query_cuda(radius, nsample, xyz, q), bq.ball_query_plain(radius, nsample, xyz, q))


# (N, M, radius, nsample): the resident route (8192) and the tiled one
# (20000, 32768: several tiles, the last one partial at 20000); M that does
# not fill a block of 16 warps; nsample 64 and nsample past N
@pytest.mark.parametrize("n,m,radius,nsample", [
    (8192, 1024, 0.1, 32), (20000, 1024, 0.1, 32), (32768, 1024, 0.1, 32), (8192, 5, 0.2, 64),
    (20000, 77, 0.05, 64), (100, 13, 2.0, 128), (20000, 9, 3.0, 30000),
])
def test_ball_query_kernel_routes_equal_plain(dev, n, m, radius, nsample):
    xyz = _cloud(n + m, (2, n, 3), dev)
    q = xyz[:, :m].contiguous()
    q[0, 0] = 10.0  # an empty ball: all zeros
    xyz[1, n // 2:] = xyz[1, : n - n // 2].clone()  # duplicates
    route = bq.plan(2, n, m, 132).route
    assert route == ("resident" if n <= bq.RESIDENT_POINTS else "tiled")
    _ball_query_equal(radius, nsample, xyz, q)


@pytest.mark.parametrize("n", [300, 8192, 20000])
def test_ball_query_kernel_launch_shapes_equal_plain(dev, n):
    # every launch shape candidate_plans() lists: both routes where the row
    # fits shared memory, 8 and 16 warps, blocks that hold one query a warp
    # and blocks that hold many
    m = 200
    xyz = _cloud(n, (2, n, 3), dev)
    q = xyz[:, :m].contiguous()
    want = bq.ball_query_plain(0.15, 32, xyz, q)
    for p in bq.candidate_plans(2, n, m, 132):
        before = bq.launches
        _equal(bq.launch(0.15, 32, xyz, q, torch.empty_like(want), p), want)
        assert bq.launches == before + 1, p


def test_ball_query_kernel_on_an_all_zero_row(dev):
    # a padded row of whole-scene training: every point hits, indices 0..k-1
    xyz = _cloud(8, (2, 8192, 3), dev)
    xyz[1] = 0.0
    q = xyz[:, :64].contiguous()
    got = bq.ball_query_cuda(0.1, 32, xyz, q)
    assert got[1].cpu().tolist() == [list(range(32))] * 64
    _ball_query_equal(0.1, 32, xyz, q)


@pytest.mark.parametrize("n,at", [(64, 3), (20000, 4100), (32768, 20000)])
def test_ball_query_kernel_radius_boundary_on_each_route(dev, n, at):
    # a point at exactly r misses, one an ulp inside hits (at a tile past
    # the first on the tiled route)
    r = np.float32(0.25)
    xyz = torch.full((1, n, 3), 3.0, device=dev)
    xyz[0, at] = torch.tensor([float(r), 0.0, 0.0])
    xyz[0, at + 1] = torch.tensor([float(np.nextafter(r, np.float32(0))), 0.0, 0.0])
    q = torch.zeros((1, 1, 3), device=dev)
    got = bq.ball_query_cuda(0.25, 4, xyz, q)
    assert got.cpu().tolist() == [[[at + 1] * 4]]
    _equal(got, bq.ball_query_plain(0.25, 4, xyz, q))

# small SSG and MSG models; the MSG one's second level takes the pregather
# composition in float32 (c_in = 16 + 16 + 3 >= 2 * 16)
SMALL_SPECS = {
    "ssg": dict(num_classes=5, input_channels=3, npoints=(64, 16), radii=((0.3,), (0.6,)),
                nsamples=((8,), (8,)), sa_mlps=(((8, 8, 16),), ((16, 16, 32),)),
                fp_mlps=((16, 16), (32, 16)), cls_fc=(16,)),
    "msg": dict(num_classes=5, input_channels=3, npoints=(64, 16),
                radii=((0.2, 0.4), (0.4, 0.8)), nsamples=((8, 16), (8, 16)),
                sa_mlps=(((8, 8, 16), (8, 16, 16)), ((16, 16, 32), (16, 24, 32))),
                fp_mlps=((16, 16), (32, 16)), cls_fc=(16,)),
}
# the ball-query kernel a model of each kind never launches
UNUSED_QUERY = {"ssg": bqm.NAME, "msg": bq.NAME}
# kernels that only a switch (ops_config), a shape or a bench script selects
OFF_BY_DEFAULT = ("gather_smem", "scatter_smem", "three_nn_q", "gather_split", "fused_gather_mm")


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_small_model_on_the_card_matches_the_cpu(dev, kind):
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, PointNet2Spec

    spec = PointNet2Spec(**SMALL_SPECS[kind])
    model = PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(0))
    pc = torch.cat([_cloud(1, (2, 256, 3), "cpu"), _cloud(2, (2, 256, 3), "cpu", -1, 1)], -1)
    with torch.inference_mode():
        want = model(pc)
        kernels.reset_launch_counts()
        got = model.to(dev)(pc.to(dev)).cpu()
    counts = kernels.launch_counts()
    assert counts.pop(sc.NAME) == 0  # no backward under inference_mode
    assert counts.pop(UNUSED_QUERY[kind]) == 0
    assert all(counts.pop(k) == 0 for k in OFF_BY_DEFAULT)
    assert all(n > 0 for n in counts.values())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)  # f32 matmul order


def test_public_ops_launch_the_kernels(dev):
    xyz = _cloud(3, (2, 512, 3), dev)
    kernels.reset_launch_counts()
    idx = ops.furthest_point_sample(xyz[:, :, :], 64)
    new_xyz = ops.gather_points(xyz, idx)
    ops.query_and_group(0.2, 16, xyz, new_xyz, xyz)
    ops.ball_query_multi((0.1, 0.2), (16, 32), xyz, new_xyz)
    ops.three_nn(xyz, new_xyz)
    assert kernels.launch_counts() == {
        "furthest_point_sample": 1, "ball_query": 1, "gather": 2, "three_nn": 1,
        "scatter_add": 0, "ball_query_multi": 1, **dict.fromkeys(OFF_BY_DEFAULT, 0),
    }


# (J, N, C) of every gather gradient of the SSG train step (grouping at SA2-4,
# interpolation at FP0-3), at batch 2; then N = 65535 on the block route (in
# row groups) and on the card-wide sort (J above 65535)
SCATTER_SHAPES = [(8192, 1024, 67), (2048, 256, 131), (512, 64, 259), (24576, 1024, 128),
                  (3072, 256, 256), (768, 64, 256), (192, 16, 512), (40, 7, 3),
                  (5000, 65535, 3), (70000, 65535, 9)]


@pytest.mark.parametrize("j,n,c", SCATTER_SHAPES)
def test_scatter_kernel_equals_plain_on_cpu_copies(dev, j, n, c):
    g = torch.Generator(device=dev).manual_seed(j + c)
    idx = torch.randint(0, max(n * 3 // 4, 1), (2, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::5] = idx[:, :1]  # one row referenced many times; a quarter never
    grad = torch.randn((2, j, c), generator=g, device=dev)
    grad *= 10.0 ** (torch.rand((2, j, 1), generator=g, device=dev) * 6 - 3)
    before = sc.launches
    got = sc.scatter_add_cuda(idx, grad, n)
    again = sc.scatter_add_cuda(idx, grad, n)
    assert sc.launches == before + 2
    _equal(got.cpu(), sc.scatter_add_plain(idx.cpu(), grad.cpu(), n))
    _equal(again, got)


@pytest.mark.parametrize("j,n,c", SCATTER_SHAPES[:8])
def test_scatter_kernel_routes_equal_plain_on_cpu_copies(dev, j, n, c):
    # every route plan() could take at the shape, launched as it is
    g = torch.Generator(device=dev).manual_seed(j + c)
    idx = torch.randint(0, max(n * 3 // 4, 1), (2, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::5] = idx[:, :1]
    grad = torch.randn((2, j, c), generator=g, device=dev)
    want = sc.scatter_add_plain(idx.cpu(), grad.cpu(), n)
    plans = sc.candidate_plans(2, n, j, c, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert len(plans) >= 2  # the block route and the card-wide sort
    for p in plans:
        _equal(sc.launch(idx, grad, n, p).cpu(), want)


@pytest.mark.parametrize("b", [2, 32])
def test_scatter_kernel_sums_a_skewed_row_in_order(dev, b):
    # FP0's shape with one output row referenced 1000 times, across pages and
    # walkers, and rows 0..9 never referenced
    g = torch.Generator(device=dev).manual_seed(b)
    j, n, c = 24576, 1024, 128
    idx = torch.randint(10, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, torch.randperm(j, generator=g, device=dev)[:900]] = 777
    idx[:, 3000:3100] = 777
    grad = torch.randn((b, j, c), generator=g, device=dev)
    grad *= 10.0 ** (torch.rand((b, j, 1), generator=g, device=dev) * 6 - 3)
    want = sc.scatter_add_plain(idx.cpu(), grad.cpu(), n)
    for p in sc.candidate_plans(b, n, j, c, torch.cuda.get_device_properties(dev).multi_processor_count):
        got = sc.launch(idx, grad, n, p)
        _equal(got.cpu(), want)
        assert not bool(got[:, :10].any())
    _equal(sc.scatter_add_cuda(idx, grad, n).cpu(), want)


@pytest.mark.parametrize("c", [128, 67])
def test_scatter_kernel_takes_rows_off_16_byte_alignment(dev, c):
    # g a contiguous view 4 bytes past an aligned allocation: the 16-byte
    # copies (C % 4 == 0) give way to 4-byte ones
    g = torch.Generator(device=dev).manual_seed(c)
    j, n = 3000, 256
    idx = torch.randint(0, n, (2, j), generator=g, device=dev, dtype=torch.int32)
    grad = torch.randn(2 * j * c + 1, generator=g, device=dev)[1:].view(2, j, c)
    assert grad.is_contiguous() and grad.data_ptr() % 16
    _equal(sc.scatter_add_cuda(idx, grad, n).cpu(), sc.scatter_add_plain(idx.cpu(), grad.cpu(), n))


def test_scatter_kernel_without_indices_gives_zeros(dev):
    idx = torch.zeros((2, 0), dtype=torch.int32, device=dev)
    got = sc.scatter_add_cuda(idx, torch.zeros((2, 0, 5), device=dev), 7)
    _equal(got, torch.zeros((2, 7, 5), device=dev))


def test_scatter_kernel_refuses_what_it_cannot_take(dev):
    idx = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="n <="):
        sc.scatter_add_cuda(idx, torch.zeros((1, 4, 3), device=dev), sc.MAX_N + 1)
    with pytest.raises(TypeError):
        sc.scatter_add_cuda(idx, torch.zeros((1, 4, 3), dtype=torch.float64, device=dev), 4)
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        sc.scatter_add_cuda(idx.cpu(), torch.zeros((1, 4, 3), device=dev), 4)


@pytest.mark.parametrize("op", ["gather_points", "group_points", "three_interpolate"])
def test_gather_gradients_on_the_card_equal_the_cpu(dev, op):
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.normal(size=(2, 200, 35)).astype(np.float32))
    if op == "three_interpolate":
        idx = torch.from_numpy(rng.integers(0, 150, (2, 300, 3)).astype(np.int32))
        w = torch.from_numpy(rng.uniform(0.1, 1, (2, 300, 3)).astype(np.float32))
        fn = lambda s, i: ops.three_interpolate(s, i, w.to(s.device))  # noqa: E731
    elif op == "group_points":
        idx = torch.from_numpy(rng.integers(0, 150, (2, 40, 8)).astype(np.int32))
        fn = ops.group_points
    else:
        idx = torch.from_numpy(rng.integers(0, 150, (2, 500)).astype(np.int32))
        fn = ops.gather_points
    out_shape = fn(src, idx).shape
    g = torch.from_numpy(rng.normal(size=out_shape).astype(np.float32))
    grads = []
    kernels.reset_launch_counts()
    for device in ("cpu", dev):
        x = src.to(device, copy=True).requires_grad_(True)
        fn(x, idx.to(device)).backward(g.to(device))
        grads.append(x.grad.cpu())
    assert kernels.launch_counts()[sc.NAME] == 1 and kernels.launch_counts()["gather"] == 1
    _equal(grads[1], grads[0])


def _train_setup(dropout, kind="ssg"):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec, ssg_spec

    spec = dataclasses.replace((msg_spec if kind == "msg" else ssg_spec)(20, 6), dropout=dropout)
    model = PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    pc = np.concatenate([rng.uniform(0, 1.5, (2, 2048, 3)), rng.uniform(-1, 1, (2, 2048, 6))], -1)
    labels = rng.integers(0, 20, (2, 2048))
    batch = {"points": torch.from_numpy(pc.astype(np.float32)),
             "labels": torch.from_numpy(labels.astype(np.int32)),
             "weights": torch.from_numpy(rng.uniform(0.5, 2, (2, 2048)).astype(np.float32))}
    schedule = ts.make_lr_schedule(1e-3, 100, 0.7, 1)
    return ts, model, batch, schedule


def _rel_l2(got, want):
    return sorted(float((got[k].double() - w).norm() / w.norm()) for k, w in want.items())


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_train_step_on_the_card_matches_the_cpu(dev, kind):
    # loss and BatchNorm statistics to float32 order; the gradients, whose
    # train-mode BatchNorm backward cancels most of dy, against a float64
    # step: the card's may be at most twice as far from it as the CPU's
    ts, model, batch, schedule = _train_setup(0.0, kind)
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), (dev, torch.float32)):
        m = copy.deepcopy(model).to(device=device, dtype=dtype)
        state = ts.create_train_state(m, schedule, seed=0)
        b = {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
             for k, v in batch.items()}
        res = ts.train_step(state, b, num_classes=20)
        out[(str(device), dtype)] = (
            float(res["loss"]), {n: p.grad.cpu() for n, p in m.named_parameters()},
            {n: b.cpu() for n, b in m.named_buffers() if b.is_floating_point()})
    ref = out[("cpu", torch.float64)][1]
    (cpu_loss, cpu_g, cpu_b) = out[("cpu", torch.float32)]
    (gpu_loss, gpu_g, gpu_b) = out[(str(dev), torch.float32)]
    assert gpu_loss == pytest.approx(cpu_loss, rel=1e-4)
    card, cpu = _rel_l2(gpu_g, ref), _rel_l2(cpu_g, ref)
    assert card[-1] <= 2 * cpu[-1] and card[len(card) // 2] <= 2 * cpu[len(cpu) // 2]
    for n, b in cpu_b.items():
        torch.testing.assert_close(gpu_b[n], b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_train_steps_on_the_card_repeat_bit_for_bit(dev, kind):
    ts, model, batch, schedule = _train_setup(0.5, kind)
    batch = {k: v.to(dev) for k, v in batch.items()}
    kernels.reset_launch_counts()
    states = []
    for _ in range(2):
        state = ts.create_train_state(copy.deepcopy(model).to(dev), schedule, seed=4)
        for _ in range(2):
            ts.train_step(state, batch, num_classes=20)
        states.append(state.model.state_dict())
    counts = kernels.launch_counts()
    assert counts.pop(UNUSED_QUERY[kind]) == 0
    assert all(counts.pop(k) == 0 for k in OFF_BY_DEFAULT)
    assert all(n > 0 for n in counts.values())
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k


# --- the kernels of the MXU-gather configuration and of the query-major 3-NN


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _special_source(b, n, c, dev, seed):
    """Float32 rows with -0.0, +-inf and NaN among random values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn((b, n, c), generator=g, device=dev)
    flat = src.view(-1)
    flat[::7] = -0.0
    flat[3::11] = float("inf")
    flat[5::13] = float("-inf")
    flat[2::17] = float("nan")
    return src


# (B, N, J, C): plan()'s tiles (test_torch_port_ops.py holds them) with
# ragged last tiles (B * J not a multiple of the tile's rows) at C = 3, 9,
# 67 and 131 (4-byte copies) and 8, 40, 128, 384 (16-byte copies), tiles
# that cross batch rows, rows too wide for 4 a tile (4103 words: one row a
# tile; 9001: two chunks of a row, one a tile); then P1's SA1 grouping and bench_gather's shapes at
# full width
SMEM_GATHER_SHAPES = [
    (2, 256, 384, 8), (2, 1024, 8192, 67), (2, 256, 2048, 131), (3, 300, 1000, 9), (2, 40, 640, 5),
    (2, 4096, 512, 384), (1, 12288, 256, 128), (2, 100, 333, 40), (2, 8192, 1001, 3),
    (3, 1024, 4099, 9), (2, 1024, 777, 67), (2, 256, 333, 131), (2, 64, 37, 4103), (1, 16, 9, 9001),
    (32, 8192, 32768, 9), (32, 8192, 32768, 64),
]


@pytest.mark.parametrize("b,n,j,c", SMEM_GATHER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_smem_kernel_equals_plain(dev, b, n, j, c, dtype):
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs

    g = torch.Generator(device=dev).manual_seed(n + c)
    if dtype == torch.float32:
        src = _special_source(b, n, c, dev, n + c)
    else:
        src = torch.randint(-2**31, 2**31 - 1, (b, n, c), generator=g, device=dev, dtype=dtype)
    idx = torch.randint(0, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    before = gs.launches
    _same_bits(gs.gather_smem_cuda(src, idx), gs.gather_smem_plain(src, idx))
    assert gs.launches == before + 1


def test_gather_split_kernel_equals_plain(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_split_kernel as gsp

    src = _special_source(2, 1024, 64, dev, 5)
    idx = torch.randint(0, 1024, (2, 4096), device=dev, dtype=torch.int32)
    before = (gs.launches, gsp.launches)
    _same_bits(gsp.gather_split_cuda(src, idx), gsp.gather_split_plain(src, idx))
    assert (gs.launches, gsp.launches) == (before[0], before[1] + 1)
    with pytest.raises(TypeError):
        gsp.gather_split_cuda(src.to(torch.int32), idx)


# (B, N, J, C): plan() on an H100 takes the accumulate route where a batch
# row's index work is small (ragged channel slices at C = 40 and 1027 and at
# P1's 67 and 131, ragged row groups at N = 300 and 128, one row a block at
# N = 60) and the
# sort route elsewhere (ragged last tiles, ragged row groups, the largest
# N); then P1's train-step backward at full width (SA2 and SA3
# groupings) and bench_gather's widest shape
SMEM_SCATTER_SHAPES = [
    (2, 256, 384, 8), (2, 1024, 8192, 67), (2, 256, 2048, 131), (3, 300, 1000, 9), (2, 128, 640, 40),
    (1, 12288, 4096, 16), (2, 60, 700, 5), (1, 65535, 5000, 3), (3, 8192, 9001, 9), (1, 40, 200, 1027),
    (32, 1024, 8192, 67), (32, 256, 2048, 131), (32, 8192, 32768, 64),
]


@pytest.mark.parametrize("b,n,j,c", SMEM_SCATTER_SHAPES)
def test_scatter_smem_kernel_equals_plain_on_cpu_copies(dev, b, n, j, c):
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    g = torch.Generator(device=dev).manual_seed(j + c)
    idx = torch.randint(0, max(n * 3 // 4, 1), (b, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::5] = idx[:, :1]  # one row referenced many times; a quarter never
    idx[:, 1:40] = idx[:, 1:2]  # a run of one row inside a group of 32
    grad = torch.randn((b, j, c), generator=g, device=dev)
    grad *= 10.0 ** (torch.rand((b, j, 1), generator=g, device=dev) * 6 - 3)
    grad.view(-1)[::9] = -0.0
    before = ss.launches
    got = ss.scatter_smem_cuda(idx, grad, n)
    again = ss.scatter_smem_cuda(idx, grad, n)
    assert ss.launches == before + 2
    _same_bits(got.cpu(), ss.scatter_smem_plain(idx.cpu(), grad.cpu(), n))
    _same_bits(again, got)
    if n <= sc.MAX_N:
        _same_bits(got, sc.scatter_add_cuda(idx, grad, n))


@pytest.mark.parametrize("c", [9, 64])
def test_scatter_smem_kernel_sums_a_skewed_row_in_order(dev, c):
    # one output row referenced 1000 times, spread over every sort tile and
    # in a run, among uniformly drawn indices; rows 0..9 never referenced
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    g = torch.Generator(device=dev).manual_seed(c)
    b, n, j = 4, 8192, 32768
    idx = torch.randint(10, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    hot = torch.randperm(j, generator=g, device=dev)[:900]
    idx[:, hot] = 4321
    idx[:, 5000:5100] = 4321
    grad = torch.randn((b, j, c), generator=g, device=dev)
    grad *= 10.0 ** (torch.rand((b, j, 1), generator=g, device=dev) * 6 - 3)
    got = ss.scatter_smem_cuda(idx, grad, n)
    _same_bits(got.cpu(), ss.scatter_smem_plain(idx.cpu(), grad.cpu(), n))
    _same_bits(ss.scatter_smem_cuda(idx, grad, n), got)
    assert not bool(got[:, :10].any())


def test_scatter_smem_kernel_without_indices_gives_zeros(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    idx = torch.zeros((2, 0), dtype=torch.int32, device=dev)
    got = ss.scatter_smem_cuda(idx, torch.zeros((2, 0, 5), device=dev), 7)
    _same_bits(got, torch.zeros((2, 7, 5), device=dev))


def test_scatter_smem_kernel_refuses_what_it_cannot_take(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    idx = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="n <="):
        ss.scatter_smem_cuda(idx, torch.zeros((1, 4, 3), device=dev), ss.MAX_N + 1)
    with pytest.raises(TypeError):
        ss.scatter_smem_cuda(idx, torch.zeros((1, 4, 3), dtype=torch.float64, device=dev), 4)


# (B, n, m): the routed shapes (FP0 at 7936 points, n = m = 8192, a query
# count under 256), small and ragged ones, duplicates for ties, and few
# queries against many known points (one row, 256 against 8192)
@pytest.mark.parametrize("b,n,m", [(32, 7936, 1024), (2, 8192, 8192), (2, 200, 128), (2, 768, 1024),
                                   (2, 8000, 1024), (3, 7, 3), (2, 50, 33), (1, 300, 2500),
                                   (32, 8192, 8192), (1, 256, 8192)])
def test_three_nn_q_kernel_equals_plain_and_three_nn(dev, b, n, m):
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_q_kernel as nnq

    unknown = _cloud(n, (b, n, 3), dev)
    known = _cloud(m + 1, (b, m, 3), dev)
    known[-1, m // 2:] = known[-1, : m - m // 2].clone()  # duplicates: exact ties
    unknown[0, :2] = known[0, :2]  # d^2 = 0
    before, before_i = nnq.launches, nn3.launches
    got = nnq.three_nn_q_cuda(unknown, known)
    assert nnq.launches == before + 1 and nn3.launches == before_i
    for want in (nnq.three_nn_q_plain(unknown, known), nn3.three_nn_cuda(unknown, known)):
        _same_bits(got[0], want[0])
        _equal(got[1], want[1])


@pytest.fixture
def mxu_config(monkeypatch):
    """The MXU-gather configuration: ops_config.vmem_gather off, mxu_gather
    on, restored afterwards."""
    from pointnet2_scannet_tpu_torch.ops import tuning

    monkeypatch.setattr(tuning.ops_config, "vmem_gather", False)
    monkeypatch.setattr(tuning.ops_config, "mxu_gather", True)


@pytest.mark.parametrize("op", ["mxu_gather", "mxu_gather_split", "group_points"])
def test_mxu_gather_gradients_on_the_card_equal_the_cpu(dev, mxu_config, op):
    from pointnet2_scannet_tpu_torch.ops import mxu_gather as mg

    rng = np.random.default_rng(8)
    src = torch.from_numpy(rng.normal(size=(2, 256, 35)).astype(np.float32))
    if op == "group_points":
        idx = torch.from_numpy(rng.integers(0, 200, (2, 64, 8)).astype(np.int32))
        fn = ops.group_points
    else:
        idx = torch.from_numpy(rng.integers(0, 200, (2, 640)).astype(np.int32))
        fn = getattr(mg, op)
    g = torch.from_numpy(rng.normal(size=tuple(idx.shape) + (35,)).astype(np.float32))
    grads = []
    kernels.reset_launch_counts()
    for device in ("cpu", dev):
        x = src.to(device, copy=True).requires_grad_(True)
        fn(x, idx.to(device)).backward(g.to(device))
        grads.append(x.grad.cpu())
    counts = kernels.launch_counts()
    forward, backward = ("gather_split", sc.NAME) if op == "mxu_gather_split" else ("gather_smem", "scatter_smem")
    assert counts[forward] == 1 and counts[backward] == 1 and counts["gather"] == 0
    _equal(grads[1], grads[0])


def test_train_step_under_the_mxu_config_matches_the_cpu(dev, mxu_config):
    # N = 512 and 128 centroids: SA1's gathers and SA2's grouping take the MXU
    # route (N % 128 == 0, J % 128 == 0), SA2's grouping with a gradient.
    # Bounds as in test_train_step_on_the_card_matches_the_cpu
    ts, _, _, schedule = _train_setup(0.0)
    spec = PointNet2Spec(**dict(SMALL_SPECS["ssg"], npoints=(128, 32), dropout=0.0))
    model = PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    pc = np.concatenate([rng.uniform(0, 1.5, (2, 512, 3)), rng.uniform(-1, 1, (2, 512, 3))], -1)
    batch = {"points": torch.from_numpy(pc), "weights": torch.ones((2, 512), dtype=torch.float64),
             "labels": torch.from_numpy(rng.integers(0, 5, (2, 512)).astype(np.int32))}
    kernels.reset_launch_counts()
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), (dev, torch.float32)):
        m = copy.deepcopy(model).to(device=device, dtype=dtype)
        state = ts.create_train_state(m, schedule, seed=0)
        b = {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
             for k, v in batch.items()}
        res = ts.train_step(state, b, num_classes=5)
        out[(str(device), dtype)] = (float(res["loss"]), {n: p.grad.cpu() for n, p in m.named_parameters()})
    counts = kernels.launch_counts()
    assert counts["gather_smem"] == 3 and counts["scatter_smem"] == 1, counts
    assert counts["three_nn_q"] == 0 and counts["gather_split"] == 0
    ref = out[("cpu", torch.float64)][1]
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = out[("cpu", torch.float32)], out[(str(dev), torch.float32)]
    assert gpu_loss == pytest.approx(cpu_loss, rel=1e-4)
    card, cpu = _rel_l2(gpu_g, ref), _rel_l2(cpu_g, ref)
    assert card[-1] <= 2 * cpu[-1] and card[len(card) // 2] <= 2 * cpu[len(cpu) // 2]


# --- the fused gather-matmul (k) and whole-scene training

# (B, N, J, C, F): bench_fused_sa's C and F at small sizes, and ragged ones
# (F % 4 != 0 takes the kernel's word-by-word stores; C * F up to 17030
# words); C 9 / F 32 takes the fixed route (J 200 and 1: a last tile that the
# 128-row tile does not fill), every other shape the general one
FUSED_SHAPES = [(2, 256, 256, 9, 32), (3, 100, 77, 5, 7), (2, 300, 129, 32, 64), (1, 64, 5, 131, 130),
                (2, 128, 128, 1, 1), (4, 1024, 1000, 3, 6), (3, 300, 200, 9, 32), (2, 50, 1, 9, 32)]


def _fused_inputs(dev, b, n, j, c, f):
    gen = torch.Generator(device=dev).manual_seed(b * n + c)
    src = torch.randn((b, n, c), generator=gen, device=dev)
    src[0, 0, 0] = -0.0
    idx = torch.randint(0, n, (b, j), generator=gen, device=dev, dtype=torch.int32)
    idx[0, 0] = 0  # the -0.0 word is gathered: 0 + (-0.0) * w must give +0.0 on both sides
    return src, idx, torch.randn((c, f), generator=gen, device=dev)


@pytest.mark.parametrize("b,n,j,c,f", FUSED_SHAPES)
def test_fused_gather_mm_kernel_equals_plain(dev, b, n, j, c, f):
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk

    src, idx, w = _fused_inputs(dev, b, n, j, c, f)
    route = fk.plan(b, n, j, c, f, build.sm_count(src)).route
    assert route == ("fixed" if (c, f) == fk.FIXED else "general")
    before = fk.launches
    _equal(fk.fused_gather_mm_cuda(src, idx, w), fk.fused_gather_mm_plain(src, idx, w))
    assert fk.launches == before + 1


@pytest.mark.parametrize("aligned", [True, False])
def test_fused_gather_mm_kernel_routes_equal_plain(dev, aligned):
    # every launch the kernel takes at a fixed-route shape whose J the tile
    # does not divide (10 tiles, every second part-filled), plus persistent
    # grids of fewer blocks than tiles (each block walks several, across
    # batch rows) and of more, each into a 16-byte-aligned output and one 4
    # bytes off it
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk

    b, n, j, c, f = 5, 300, 200, 9, 32
    src, idx, w = _fused_inputs(dev, b, n, j, c, f)
    want = fk.fused_gather_mm_plain(src, idx, w)
    plans = fk.candidate_plans(b, n, j, c, f, build.sm_count(src))
    assert {p.route for p in plans} == set(fk.ROUTES)
    plans += [fk.Plan("fixed", k) for k in (1, 3, 4, 7, 23)] + [fk.Plan("general", 3)]
    for p in plans:
        buf = torch.full((b * j * f + 1,), float("nan"), device=dev)
        out = (buf[:-1] if aligned else buf[1:]).view(b, j, f)
        assert (out.data_ptr() % 16 == 0) == aligned
        before = fk.launches
        _equal(fk.launch(src, idx, w, out, p), want)
        assert fk.launches == before + 1, p


def test_fused_gather_mm_kernel_takes_more_batch_rows_than_a_grid_dimension(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk

    b, n, j, c, f = build.MAX_BATCH + 2, 3, 5, 9, 32
    src, idx, w = _fused_inputs(dev, b, n, j, c, f)
    assert fk.plan(b, n, j, c, f, build.sm_count(src)).route == "fixed"
    before = fk.launches
    _equal(fk.fused_gather_mm_cuda(src, idx, w), fk.fused_gather_mm_plain(src, idx, w))
    assert fk.launches == before + 1


def test_fused_gather_mm_op_launches_the_kernel_and_refuses_what_it_cannot_take(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk

    src = _cloud(5, (2, 256, 9), dev)
    idx = torch.randint(0, 256, (2, 384), device=dev, dtype=torch.int32)
    w = _cloud(6, (9, 32), dev, -1, 1)
    kernels.reset_launch_counts()
    _equal(ops.fused_gather_mm(src, idx, w), fk.fused_gather_mm_plain(src, idx, w))
    assert kernels.launch_counts() == {k: int(k in ("fused_gather_mm",)) for k in kernels.launch_counts()}
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.fused_gather_mm(src, idx[:, :100], w)
    with pytest.raises(ValueError, match="C \\* F <="):
        fk.fused_gather_mm_cuda(src, idx, torch.zeros((9, 6000), device=dev))
    with pytest.raises(TypeError, match="float32"):
        fk.fused_gather_mm_cuda(src.double(), idx, w)
    with pytest.raises(ValueError, match="do not match"):
        fk.fused_gather_mm_cuda(src, idx, w[:8])


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_wholescene_update_on_the_card_matches_the_cpu(dev, kind):
    # one scene of 3 columns at micro-batch 2 (the second padded); the
    # bounds of test_train_step_on_the_card_matches_the_cpu, but the worst of
    # the ~70 per-tensor gradient errors may be 4x the CPU's, not 2x: with a
    # micro-batch of one real 2048-point row it is one draw of float32 noise
    # (measured 2.2x the CPU's worst for SSG, in two calls on an H100)
    from pointnet2_scannet_tpu_torch.engine.solver import _SceneBatchIterator

    ts, model, batch, schedule = _train_setup(0.0, kind)
    scene = [torch.cat([v, v[:1]]).numpy() for v in (batch["points"], batch["labels"], batch["weights"])]
    micro = list(_SceneBatchIterator(None, 2).micro_batches(*scene))
    assert micro[1]["row_mask"].tolist() == [1.0, 0.0]
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), (dev, torch.float32)):
        m = copy.deepcopy(model).to(device=device, dtype=dtype)
        state = ts.create_train_state(m, schedule, seed=0)
        kernels.reset_launch_counts()
        res = [ts.grad_accum_step(state, {k: torch.from_numpy(v).to(device=device, dtype=dtype if k in (
            "points", "weights") else None) for k, v in mb.items()}, num_classes=20) for mb in micro]
        count = float(sum(r["count"] for r in res))
        out[(str(device), dtype)] = (
            float(sum(r["loss_sum"] for r in res)), {n: p.grad.cpu() / count for n, p in m.named_parameters()},
            {n: b.cpu() for n, b in m.named_buffers() if b.is_floating_point()})
        ts.apply_accumulated(state, count)
        assert state.step == 1 and count == 3 * 2048
    counts = kernels.launch_counts()  # the card's run
    assert counts.pop(UNUSED_QUERY[kind]) == 0
    assert all(counts.pop(k) == 0 for k in OFF_BY_DEFAULT)
    assert all(n > 0 for n in counts.values())
    ref = out[("cpu", torch.float64)][1]
    (cpu_loss, cpu_g, cpu_b) = out[("cpu", torch.float32)]
    (gpu_loss, gpu_g, gpu_b) = out[(str(dev), torch.float32)]
    assert gpu_loss == pytest.approx(cpu_loss, rel=1e-4)
    card, cpu = _rel_l2(gpu_g, ref), _rel_l2(cpu_g, ref)
    assert card[len(card) // 2] <= 2 * cpu[len(cpu) // 2], (card[len(card) // 2], cpu[len(cpu) // 2])
    assert card[-1] <= 4 * cpu[-1], (card[-1], cpu[-1])
    for n, b in cpu_b.items():
        torch.testing.assert_close(gpu_b[n], b, rtol=1e-4, atol=1e-4)


# --- the device-resident scene store (data/resident.py)


def _resident(augment):
    """A flat store of 4 synthetic scenes and one resident batch of 2 x 2048
    rows from it, on the CPU."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import ResidentBatchLoader, flatten_store, make_synthetic_store
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset

    cfg = DataConfig(npoints=2048, use_color=True, use_normal=True, augment=augment)
    scenes = make_synthetic_store(4, seed=0, n_points=20000)
    ds = ChunkedSceneDataset(scenes, cfg, phase="train", seed=0, resident=True)
    ds.generate_chunks()
    pts, labels = flatten_store(scenes, cfg)
    store = {"points": torch.from_numpy(pts), "labels": torch.from_numpy(labels),
             "wtable": torch.from_numpy(scenes.label_weights.astype(np.float32))}
    return store, {k: torch.from_numpy(v) for k, v in next(iter(ResidentBatchLoader(ds, 2))).items()}


def _on(d, dev):
    return {k: v.to(dev) for k, v in d.items()}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_materialize_batch_on_the_card_matches_gather_plain_and_the_cpu(dev, augment):
    from pointnet2_scannet_tpu_torch.data import materialize_batch

    store, batch = _resident(augment)
    want = materialize_batch(store, batch)
    kernels.reset_launch_counts()
    got = materialize_batch(_on(store, dev), _on(batch, dev))
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0) | {"gather": 2}
    rows = batch["idx"].to(dev).view(1, -1)
    plain = ga.gather_plain(store["points"].to(dev).unsqueeze(0), rows).view(2, 2048, 9)
    _equal(got["labels"], ga.gather_plain(store["labels"].to(dev).view(1, -1, 1), rows).view(2, 2048))
    if augment:  # the transform's float32 sums run in another order on the card
        _equal(got["points"][..., 3:], plain[..., 3:])
        torch.testing.assert_close(got["points"][..., :3].cpu(), want["points"][..., :3], rtol=0, atol=1e-5)
    else:
        _equal(got["points"], plain)
        _equal(got["points"].cpu(), want["points"])
    for k in ("labels", "weights", "row_mask"):
        _equal(got[k].cpu(), want[k])


def test_resident_train_steps_launch_two_store_gathers_each(dev):
    # the same batch as a host batch and through the store: the same losses
    # bit for bit, and d launched twice more a step
    from pointnet2_scannet_tpu_torch.data import materialize_batch

    ts, model, _, schedule = _train_setup(0.5)
    store, batch = _resident(False)
    store, batch = _on(store, dev), _on(batch, dev)
    dense = materialize_batch(store, batch)
    counts, losses = [], []
    for resident in (False, True):
        state = ts.create_train_state(copy.deepcopy(model).to(dev), schedule, seed=0)
        kernels.reset_launch_counts()
        losses.append([float((ts.resident_train_step(state, store, batch, num_classes=20) if resident
                              else ts.train_step(state, dense, num_classes=20))["loss"]) for _ in range(2)])
        counts.append(kernels.launch_counts())
    assert counts[1] == counts[0] | {"gather": counts[0]["gather"] + 4}
    assert losses[1] == losses[0]


# --- bfloat16 rows (the bfloat16 compute dtype): d's int32-pair and 2-byte
# routes, h's bfloat16 routes (float32 sums rounded once), the bf16 models

# (B, N, J, C) of bfloat16 gathers: SSG's packed SA1 and SA2 payloads (6 + 6,
# 6 + 64), MSG's SA2 (6 + 96), an FP row (128), an odd payload (6 + 3: the
# 2-byte route), ragged and tiny shapes
BF16_GATHER_SHAPES = [(2, 8192, 32768, 12), (2, 1024, 8192, 70), (2, 1024, 8192, 102), (2, 1024, 24576, 128),
                      (2, 8192, 32768, 9), (3, 50, 1001, 3), (1, 5, 1, 256), (2, 1, 7, 2)]


@pytest.mark.parametrize("b,n,j,c", BF16_GATHER_SHAPES)
def test_gather_kernel_bf16_equals_plain(dev, b, n, j, c):
    g = torch.Generator(device=dev).manual_seed(j + c)
    src = torch.randn((b, n, c), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    before, before_bf16 = ga.launches, ga.bf16_launches
    _equal(ga.gather_cuda(src, idx), ga.gather_plain(src, idx))
    assert (ga.launches, ga.bf16_launches) == (before + 1, before_bf16 + 1)


def test_gather_kernel_bf16_takes_a_row_start_off_4_bytes(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    src = torch.randn(2 * 300 * 12 + 1, generator=g, device=dev).to(torch.bfloat16)[1:].view(2, 300, 12)
    idx = torch.randint(0, 300, (2, 1000), generator=g, device=dev, dtype=torch.int32)
    assert src.is_contiguous() and src.data_ptr() % 4 == 2
    _equal(ga.gather_cuda(src, idx), ga.gather_plain(src, idx))


@pytest.mark.parametrize("j,n,c", SCATTER_SHAPES + [(8192, 1024, 70), (2048, 256, 134), (4096, 256, 102)])
def test_scatter_kernel_bf16_equals_plain_on_cpu_copies(dev, j, n, c):
    g = torch.Generator(device=dev).manual_seed(j + c)
    idx = torch.randint(0, max(n * 3 // 4, 1), (2, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::5] = idx[:, :1]
    grad = torch.randn((2, j, c), generator=g, device=dev)
    grad = (grad * 10.0 ** (torch.rand((2, j, 1), generator=g, device=dev) * 6 - 3)).to(torch.bfloat16)
    want = sc.scatter_add_plain(idx.cpu(), grad.cpu(), n)
    before = sc.bf16_launches
    got = sc.scatter_add_cuda(idx, grad, n)
    assert sc.bf16_launches == before + 1
    _equal(got.cpu(), want)
    _equal(sc.scatter_add_cuda(idx, grad, n), got)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for p in sc.candidate_plans(2, n, j, c, sms, 2):  # every route at the shape
        _equal(sc.launch(idx, grad, n, p).cpu(), want)


def test_scatter_kernel_bf16_takes_cotangents_off_16_bytes(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    j, n, c = 4096, 512, 128
    idx = torch.randint(0, n, (2, j), generator=g, device=dev, dtype=torch.int32)
    grad = torch.randn(2 * j * c + 1, generator=g, device=dev).to(torch.bfloat16)[1:].view(2, j, c)
    assert grad.data_ptr() % 16 != 0
    _equal(sc.scatter_add_cuda(idx, grad, n).cpu(), sc.scatter_add_plain(idx.cpu(), grad.cpu(), n))


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_bf16_small_model_on_the_card_matches_the_cpu(dev, kind):
    # bfloat16 GEMMs round in other places in cuBLAS and the CPU's BLAS:
    # the bound is the CPU tests' logit bound against the JAX model
    spec = PointNet2Spec(**SMALL_SPECS[kind])
    model = PointNet2SemSeg(spec, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    pc = torch.cat([_cloud(1, (2, 256, 3), "cpu"), _cloud(2, (2, 256, 3), "cpu", -1, 1)], -1)
    with torch.inference_mode():
        want = model(pc)
        kernels.reset_launch_counts()
        got = model.to(dev)(pc.to(dev)).cpu()
    assert kernels.bf16_launch_counts()["gather"] > 0
    assert float((got - want).abs().max()) <= 0.04 * float(want.abs().max())


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_bf16_train_steps_on_the_card_repeat_bit_for_bit_through_d_and_h(dev, kind):
    ts, model, batch, schedule = _train_setup(0.5, kind)
    model = PointNet2SemSeg(model.spec, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    batch = {k: v.to(dev) for k, v in batch.items()}
    kernels.reset_launch_counts()
    states = []
    for _ in range(2):
        state = ts.create_train_state(copy.deepcopy(model).to(dev), schedule, seed=4)
        for _ in range(2):
            ts.train_step(state, batch, num_classes=20)
        states.append(state.model.state_dict())
    bf16 = kernels.bf16_launch_counts()
    assert bf16["gather"] > 0 and bf16["scatter_add"] > 0
    for k, v in states[0].items():
        assert v.dtype == torch.float32 or not v.is_floating_point(), k
        assert torch.equal(states[1][k], v), k


# --- bfloat16 rows on the MXU-gather route: e (int32 lane pairs, 2-byte
# words for odd C), g, and f's tile-by-tile bfloat16 sum (J % 128 == 0)

# (B, N, J, C) of bfloat16 gathers through gather_smem.cu: P1's packed SA1-SA3
# payloads (6 + 3 odd, 6 + 6, 6 + 64, 6 + 128), bench_gather's widths, ragged
# tiles at odd C, a row too wide for 8 a tile (the 2-byte chunk route) and one
# wide even row (4-byte chunks of pairs)
SMEM_BF16_SHAPES = [(32, 8192, 32768, 9), (32, 8192, 32768, 12), (32, 1024, 8192, 70), (32, 256, 2048, 134),
                    (32, 8192, 32768, 32), (32, 8192, 32768, 64), (3, 300, 1000, 9), (2, 100, 333, 5),
                    (2, 64, 37, 4103), (1, 16, 9, 20002), (2, 8192, 1001, 1)]


@pytest.mark.parametrize("b,n,j,c", SMEM_BF16_SHAPES)
def test_gather_smem_kernel_bf16_equals_plain(dev, b, n, j, c):
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs

    g = torch.Generator(device=dev).manual_seed(n + c)
    src = _special_source(b, n, c, dev, n + c).to(torch.bfloat16)
    idx = torch.randint(0, n, (b, j), generator=g, device=dev, dtype=torch.int32)
    before = (gs.launches, gs.bf16_launches)
    got = gs.gather_smem_cuda(src, idx)
    assert (gs.launches, gs.bf16_launches) == (before[0] + 1, before[1] + 1)
    _same_bits(got.view(torch.int16), gs.gather_smem_plain(src, idx).view(torch.int16))


def test_gather_smem_kernel_bf16_takes_a_row_start_off_4_bytes(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs

    g = torch.Generator(device=dev).manual_seed(10)
    src = torch.randn(2 * 256 * 12 + 1, generator=g, device=dev).to(torch.bfloat16)[1:].view(2, 256, 12)
    idx = torch.randint(0, 256, (2, 1024), generator=g, device=dev, dtype=torch.int32)
    assert src.is_contiguous() and src.data_ptr() % 4 == 2
    _same_bits(gs.gather_smem_cuda(src, idx).view(torch.int16), gs.gather_smem_plain(src, idx).view(torch.int16))


@pytest.mark.parametrize("c", [9, 32])
def test_gather_split_kernel_bf16_equals_plain(dev, c):
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_split_kernel as gsp

    src = _special_source(2, 1024, c, dev, 6).to(torch.bfloat16)
    idx = torch.randint(0, 1024, (2, 4096), device=dev, dtype=torch.int32)
    before = gsp.bf16_launches
    _same_bits(gsp.gather_split_cuda(src, idx).view(torch.int16), gsp.gather_split_plain(src, idx).view(torch.int16))
    assert gsp.bf16_launches == before + 1


# (B, N, J, C): P1's SA2 and SA3 backwards at full width (6 + 64, 6 + 128),
# MSG's SA2 (6 + 96), bench_gather's shapes, one tile, a tile of 128 at N
# = 65535, and small ragged widths
SMEM_BF16_SCATTER_SHAPES = [(32, 1024, 8192, 70), (32, 256, 2048, 134), (32, 1024, 4096, 102),
                            (32, 8192, 32768, 9), (32, 8192, 32768, 64), (2, 256, 128, 8), (1, 65535, 256, 3),
                            (3, 300, 1024, 40), (2, 40, 640, 1027)]


@pytest.mark.parametrize("b,n,j,c", SMEM_BF16_SCATTER_SHAPES)
def test_scatter_smem_kernel_bf16_equals_plain_on_cpu_copies(dev, b, n, j, c):
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    g = torch.Generator(device=dev).manual_seed(j + c)
    idx = torch.randint(0, max(n * 3 // 4, 1), (b, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::5] = idx[:, :1]  # one row named in every tile; a quarter never
    grad = torch.randn((b, j, c), generator=g, device=dev)
    grad = (grad * 10.0 ** (torch.rand((b, j, 1), generator=g, device=dev) * 6 - 3)).to(torch.bfloat16)
    before = (ss.launches, ss.bf16_launches)
    got = ss.scatter_smem_cuda(idx, grad, n)
    again = ss.scatter_smem_cuda(idx, grad, n)
    assert (ss.launches, ss.bf16_launches) == (before[0] + 2, before[1] + 2)
    want = ss.scatter_smem_plain(idx.cpu(), grad.cpu(), n)
    _same_bits(got.cpu().view(torch.int16), want.view(torch.int16))
    _same_bits(again.view(torch.int16), got.view(torch.int16))


def test_scatter_smem_kernel_bf16_sums_a_skewed_row_tile_by_tile(dev):
    # phase 4's skewed row (N 65535, one output named ~1000 times over J =
    # 131072) in bfloat16: the card-wide sort with the per-tile rounding
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, 65535, (2, 131072), generator=g, device=dev, dtype=torch.int32)
    idx[:, torch.randperm(131072, generator=g, device=dev)[:1000]] = 4321
    grad = torch.randn((2, 131072, 64), generator=g, device=dev).to(torch.bfloat16)
    got = ss.scatter_smem_cuda(idx, grad, 65535).cpu()
    _same_bits(got.view(torch.int16), ss.scatter_smem_plain(idx.cpu(), grad.cpu(), 65535).view(torch.int16))
    once = sc.scatter_add_plain(idx.cpu(), grad.cpu(), 65535)  # the other order differs at the hot row
    assert not torch.equal(got[:, 4321], once[:, 4321])


def test_scatter_smem_kernel_bf16_refuses_a_ragged_tile(dev):
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    idx = torch.zeros((1, 200), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="J % 128 == 0"):
        ss.scatter_smem_cuda(idx, torch.zeros((1, 200, 3), dtype=torch.bfloat16, device=dev), 4)


def test_bf16_train_steps_under_the_mxu_config_repeat_bit_for_bit_through_e_and_f(dev, mxu_config):
    # N = 512 and 128 centroids: the packed groupings of SA1 and SA2 take e
    # on bfloat16 rows, SA2's gradient f; two runs of two steps agree
    ts, _, _, schedule = _train_setup(0.5)
    spec = PointNet2Spec(**dict(SMALL_SPECS["ssg"], npoints=(128, 32)))
    model = PointNet2SemSeg(spec, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    pc = np.concatenate([rng.uniform(0, 1.5, (2, 512, 3)), rng.uniform(-1, 1, (2, 512, 3))], -1)
    batch = {"points": torch.from_numpy(pc.astype(np.float32)).to(dev),
             "weights": torch.ones((2, 512), device=dev),
             "labels": torch.from_numpy(rng.integers(0, 5, (2, 512)).astype(np.int32)).to(dev)}
    kernels.reset_launch_counts()
    states = []
    for _ in range(2):
        state = ts.create_train_state(copy.deepcopy(model).to(dev), schedule, seed=4)
        for _ in range(2):
            ts.train_step(state, batch, num_classes=5)
        states.append(state.model.state_dict())
    bf16 = kernels.bf16_launch_counts()
    assert bf16["gather_smem"] == 2 * 2 * 2 and bf16["scatter_smem"] == 2 * 2
    assert kernels.launch_counts()["gather_smem"] == 2 * 2 * 3  # and SA1's float32 centroids
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k


# ------------------------------------------------ the pn2:: ops and the serving artifacts


def _op_cases(dev):
    """name -> (pn2:: op, its arguments on the card, its plain version, the
    kernel module that counts its launches)."""
    from pointnet2_scannet_tpu_torch.ops import library
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_q_kernel as nnq

    xyz = _cloud(0, (2, 512, 3), dev)
    q = xyz[:, :128].contiguous()
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 256), dtype=np.int32)).to(dev)
    feats = _cloud(2, (2, 512, 12), dev, -1, 1)
    words = torch.from_numpy(np.random.default_rng(3).integers(-2**31, 2**31 - 1, (2, 512, 3),
                                                                dtype=np.int32)).to(dev)
    return {
        "a": (library.furthest_point_sample, (xyz, 128, True), lambda: fps.furthest_point_sample_plain(xyz, 128),
              fps),
        "b": (library.ball_query, (0.2, 32, xyz, q), lambda: bq.ball_query_plain(0.2, 32, xyz, q), bq),
        "c": (library.ball_query_multi, ([0.1, 0.2], [16, 32], xyz, q),
              lambda: bqm.ball_query_multi_plain((0.1, 0.2), (16, 32), xyz, q), bqm),
        "d_f32": (library.gather, (feats, idx), lambda: ga.gather_plain(feats, idx), ga),
        "d_i32": (library.gather, (words, idx), lambda: ga.gather_plain(words, idx), ga),
        "d_bf16": (library.gather, (feats.bfloat16(), idx), lambda: ga.gather_plain(feats.bfloat16(), idx), ga),
        "e_f32": (library.gather_smem, (feats, idx), lambda: gs.gather_smem_plain(feats, idx), gs),
        "e_bf16": (library.gather_smem, (feats.bfloat16(), idx),
                   lambda: gs.gather_smem_plain(feats.bfloat16(), idx), gs),
        "i": (library.three_nn, (xyz, q), lambda: nn3.three_nn_plain(xyz, q), nn3),
        "j": (library.three_nn_q, (xyz, q), lambda: nnq.three_nn_q_plain(xyz, q), nnq),
    }


@pytest.mark.parametrize("case", ["a", "b", "c", "d_f32", "d_i32", "d_bf16", "e_f32", "e_bf16", "i", "j"])
def test_op_on_the_card_launches_its_kernel_and_equals_plain(dev, case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, plain, module = _op_cases(dev)[case]
    before = module.launches
    got = op(*args)
    assert module.launches == before + 1
    want = plain()
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    for g, w in zip(got, want, strict=True):
        _equal(g, w)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert module.launches == before + 1  # the fake impl launches nothing
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype, f.device) for f in fake] == [(g.shape, g.dtype, g.device) for g in got]


def _serving_columns(s):
    return np.concatenate([_cloud(4, (s, 256, 3), "cpu").numpy(), _cloud(5, (s, 256, 3), "cpu", -1, 1).numpy()],
                          -1)


@pytest.mark.parametrize("kind,dtype", [("ssg", None), ("msg", None), ("ssg", torch.bfloat16)],
                         ids=["ssg", "msg", "ssg_bf16"])
def test_card_artifact_labels_equal_the_predictor(dev, tmp_path, kind, dtype):
    from pointnet2_scannet_tpu_torch.engine import export

    model = PointNet2SemSeg(PointNet2Spec(**SMALL_SPECS[kind]), dtype=dtype,
                            generator=torch.Generator().manual_seed(0))
    x = _serving_columns(5)  # ragged onto a batch of 2
    shape = dict(batch_size=2, npoints=256, channels=6, num_classes=5)
    want = export.Predictor(model, device=dev, **shape).predict(x)
    exported = export.export_forward(model, platforms=["cuda"], **shape)
    assert exported.device == f"cuda:{torch.cuda.current_device()}" and exported.num_nodes < 2000
    loaded = export.load_exported(export.save_exported(exported, tmp_path / "m.pt2"))
    kernels.reset_launch_counts()
    got = export.ServingPredictor(loaded).predict(x)
    counts = kernels.launch_counts()
    np.testing.assert_array_equal(got, want)
    assert counts.pop(sc.NAME) == 0 and counts.pop(UNUSED_QUERY[kind]) == 0
    assert all(counts.pop(k) == 0 for k in OFF_BY_DEFAULT)
    assert all(n > 0 for n in counts.values())
    twice = export.ServingPredictor(loaded, devices=["cuda:0", "cuda:0"]).predict(x)
    np.testing.assert_array_equal(twice, want)
    with pytest.raises(ValueError, match=r"platforms \['cuda'\]; cannot serve on \['cpu'\]"):
        export.ServingPredictor(loaded, devices=["cpu"])


def test_cpu_traced_artifact_serves_on_the_card(dev, tmp_path):
    # traced on the CPU (its routes: every 3-NN is three_nn, i), moved to
    # the card by ServingPredictor
    from pointnet2_scannet_tpu_torch.engine import export

    model = PointNet2SemSeg(PointNet2Spec(**SMALL_SPECS["ssg"]), generator=torch.Generator().manual_seed(0))
    shape = dict(batch_size=2, npoints=256, channels=6, num_classes=5)
    exported = export.export_forward(model, platforms=["cpu", "cuda"], **shape)
    loaded = export.load_exported(export.save_exported(exported, tmp_path / "m.pt2"))
    x = _serving_columns(3)
    kernels.reset_launch_counts()
    got = export.ServingPredictor(loaded, devices=["cuda"]).predict(x)
    counts = kernels.launch_counts()
    np.testing.assert_array_equal(got, export.Predictor(model, device=dev, **shape).predict(x))
    np.testing.assert_array_equal(export.ServingPredictor(loaded, devices=["cpu"]).predict(x), got)
    assert counts["three_nn"] == 2 * 2 and counts["three_nn_q"] == 0  # 2 batches x 2 FP levels
    assert counts["furthest_point_sample"] == 2 * 2 and counts["gather"] > 0 and counts[sc.NAME] == 0


# ENet (models/enet.py) in float32, TF32 off: cuDNN's convolutions against
# the CPU's at the JAX package's reference-parity tolerance
ENET_RTOL, ENET_ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (2, 256, 328, 3)])
def test_enet_on_the_card_matches_the_cpu(dev, shape):
    from pointnet2_scannet_tpu_torch.models.enet import ENetSemSeg

    torch.manual_seed(0)
    model = ENetSemSeg(41).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    with torch.inference_mode():
        want = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    assert got.shape == (shape[0], shape[1] // 8, shape[2] // 8, 41)
    torch.testing.assert_close(got, want, rtol=ENET_RTOL, atol=ENET_ATOL)


def test_correspondence_and_fusion_on_the_card_equal_the_cpu(dev):
    """One elementwise op a step on either device: equal bit for bit."""
    from pointnet2_scannet_tpu_torch.data import multiview as mv
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene, make_synthetic_views

    scene = make_synthetic_scene(3, n_points=20_000)
    poses, depths = make_synthetic_views(scene, 8, mv.CameraConfig(), seed=3)
    points = torch.from_numpy(np.ascontiguousarray(scene[:, :3]))
    want_v, want_p = mv.compute_correspondence_batch(points, depths, poses)
    got_v, got_p = mv.compute_correspondence_batch(points.to(dev), depths, poses)
    _equal(got_v.cpu(), want_v)
    _equal(got_p.cpu(), want_p)
    feats = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 32, 41, 16)).astype(np.float32))
    _equal(mv.fuse_scene_features(feats.to(dev), got_v, got_p).cpu(), mv.fuse_scene_features(feats, want_v, want_p))


# --- the fused steps: one CUDA graph launch of K steps against K eager steps


def _fused_step_batches(k, n=1024, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        pc = np.concatenate([rng.uniform(0, 1.5, (2, n, 3)), rng.uniform(-1, 1, (2, n, 6))], -1)
        out.append({"points": pc.astype(np.float32), "labels": rng.integers(0, 20, (2, n)).astype(np.int32),
                    "weights": rng.uniform(0.5, 2, (2, n)).astype(np.float32), "row_mask": np.ones(2, np.float32)})
    return out


def _whole_state(state):
    opt = state.optimizer
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [{k: v.clone() for k, v in opt.state[p].items()} for p in state.model.parameters()],
            state.generator.get_state(), state.step)


@pytest.mark.parametrize("kind,dtype,resident,n", [("ssg", None, False, 1024), ("msg", None, False, 1024),
                                                   ("ssg", torch.bfloat16, False, 1024), ("ssg", None, True, 1024),
                                                   ("ssg", None, False, 20000)],
                         ids=["ssg", "msg", "ssg-bf16", "ssg-resident", "ssg-fps-cluster"])
def test_fused_graph_of_two_steps_equals_two_eager_steps(dev, kind, dtype, resident, n):
    # Dropout on, the rate halving inside the second group; two launches
    # (capture, then a plain replay), each bit for bit against 2 eager steps;
    # at 20000 points a row SA1's FPS takes the cluster launch
    from pointnet2_scannet_tpu_torch.data.pipeline import HostGroup
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import msg_spec, ssg_spec
    from pointnet2_scannet_tpu_torch.parallel.step import make_fused_train_step, make_resident_fused_train_step

    k = 2
    spec = dataclasses.replace((msg_spec if kind == "msg" else ssg_spec)(20, 6), dropout=0.5)
    model = PointNet2SemSeg(spec, dtype=dtype, generator=torch.Generator().manual_seed(0))
    schedule = ts.make_lr_schedule(1e-3, 3, 0.5, 1)
    eager, graph = (ts.create_train_state(copy.deepcopy(model).to(dev), schedule, seed=4) for _ in range(2))
    make = make_resident_fused_train_step if resident else make_fused_train_step
    fused = make(graph.model, None, num_classes=20)
    assert fused.mode == "graph" and fused.describe(k) == "fused_steps 2: one CUDA graph per 2 steps"
    store = None
    if resident:
        flat = _fused_step_batches(2 * k, n)
        store = {"points": torch.from_numpy(np.concatenate([b["points"].reshape(-1, 9) for b in flat])).to(dev),
                 "labels": torch.from_numpy(np.concatenate([b["labels"].reshape(-1) for b in flat])).to(dev),
                 "wtable": torch.linspace(0.5, 2.0, 20, device=dev)}
    per_step = None
    for group in range(2):
        if resident:
            rows = np.random.default_rng(group).permutation(2 * k * 2 * n).astype(np.int32)
            batches = [{"idx": rows[i * 2 * n : (i + 1) * 2 * n].reshape(2, n), "row_mask": np.ones(2, np.float32)}
                       for i in range(k)]
        else:
            batches = _fused_step_batches(k, n, seed=group)
        kernels.reset_launch_counts()
        want = []
        for b in batches:
            b = {name: torch.from_numpy(v).to(dev) for name, v in b.items()}
            want.append(ts.resident_train_step(eager, store, b, num_classes=20) if resident
                        else ts.train_step(eager, b, num_classes=20))
        per_step = per_step or {name: c // k for name, c in kernels.launch_counts().items()}
        kernels.reset_launch_counts()
        host = HostGroup(batches, pin=True)
        got = fused(graph, store, host) if resident else fused(graph, host)
        torch.cuda.synchronize()
        assert torch.equal(got["loss"], torch.stack([w["loss"] for w in want]))
        assert torch.equal(got["confusion"], torch.stack([w["confusion"] for w in want]))
        g_model, g_adam, g_gen, g_step = _whole_state(graph)
        e_model, e_adam, e_gen, e_step = _whole_state(eager)
        assert g_step == e_step == (group + 1) * k and torch.equal(g_gen, e_gen)
        for name, v in e_model.items():
            assert torch.equal(g_model[name], v), name
        for x, y in zip(g_adam, e_adam):
            for name, v in y.items():
                assert torch.equal(x[name], v), name
    # the capture counted k steps' launches; the replay counted none
    assert kernels.fps_kernel.plan(n, torch.float32).variant == ("cluster" if n > 16384 else "block")
    assert len(fused.captures) == 1
    assert fused.captures[0]["launches"] == {name: k * c for name, c in per_step.items()}
    assert all(c == 0 for c in kernels.launch_counts().values())


def _votes_modules(dev):
    """The votenet modules at small widths, built on the CPU from one seed,
    and their card copies."""
    from pointnet2_scannet_tpu_torch.models import (
        LearnableFeaturePropagationMSG,
        SetAbstractionMSGVotes,
        SetAbstractionVotes,
    )

    torch.manual_seed(0)
    cpu = {
        "sa_max": SetAbstractionVotes((32, 64), 1, npoint=256, radius=0.2, nsample=64, normalize_xyz=True,
                                      ret_unique_cnt=True),
        "sa_rbf": SetAbstractionVotes((32, 64), 1, npoint=256, radius=0.3, nsample=16, pooling="rbf"),
        "msg": SetAbstractionMSGVotes(256, (0.1, 0.2), (16, 32), ((16, 32), (32, 64)), 1),
        "lfp": LearnableFeaturePropagationMSG(((16, 32), (16, 32)), (0.2, 0.4), (16, 32), (48,), 1, 96),
    }
    return cpu, {k: copy.deepcopy(m).to(dev) for k, m in cpu.items()}


def _run_votes(mods, xyz, feats):
    """Every module's outputs on one cloud, and the sum that a backward takes."""
    out = {}
    for name in ("sa_max", "sa_rbf", "msg"):
        out[name] = mods[name](xyz, feats)
    new_xyz, f2 = out["msg"][0], out["msg"][1]
    out["lfp"] = (mods["lfp"](new_xyz, xyz, f2, feats),)
    loss = sum(o[1].square().mean() for k, o in out.items() if k != "lfp") + out["lfp"][0].square().mean()
    return out, loss


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_votes_modules_on_the_card_match_the_cpu(dev, train):
    # the outputs, unique counts and gradients of the cloud's features to
    # float32 order; the kernels launched: FPS, the single- and two-radius
    # ball queries, the gather, and the scatter-add in the backward
    cpu, card = _votes_modules(dev)
    xyz = _cloud(31, (2, 2048, 3), "cpu", -1.0, 1.0)
    feats = xyz[..., 2:3].clone()
    results = []
    for mods, d in ((cpu, "cpu"), (card, dev)):
        for m in mods.values():
            m.train(train)
        f = feats.to(d).detach().requires_grad_(train)
        kernels.reset_launch_counts()
        out, loss = _run_votes(mods, xyz.to(d), f)
        if train:
            loss.backward()
        torch.cuda.synchronize()
        results.append((out, f.grad, kernels.launch_counts()))
    (cpu_out, cpu_grad, _), (out, grad, launches) = results
    for name, outs in cpu_out.items():
        for a, b in zip(out[name], outs):
            if b is None:
                continue
            if b.is_floating_point():
                torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
            else:
                _equal(a.cpu(), b)
    # gathers: each SA's centroids, grouped xyz and grouped features (3 + 3),
    # MSG's centroids and two groupings, LFP's two groupings; the features'
    # six groupings take a scatter-add in the backward
    want = {"furthest_point_sample": 3, "ball_query": 2, "ball_query_multi": 2, "gather": 11,
            "scatter_add": 6 if train else 0}
    assert {k: launches[k] for k in want} == want
    if train:
        torch.testing.assert_close(grad.cpu(), cpu_grad, rtol=1e-4, atol=1e-4)


def test_unique_count_and_resample_on_the_cards_ball_query_rows(dev):
    # b's rows on the card: the ascending prefix and first-hit padding that
    # unique_neighbor_count reads, with empty, short and full balls
    xyz = torch.cat([_cloud(32, (2, 1024, 3), dev, -1.0, 1.0), _cloud(33, (2, 64, 3), dev, -0.02, 0.02)], 1)
    q = torch.cat([xyz[:, :192], xyz[:, 1024:1056], _cloud(34, (2, 32, 3), dev, 5.0, 6.0)], 1)
    idx = bq.ball_query_cuda(0.2, 64, xyz, q)
    _equal(idx, bq.ball_query_plain(0.2, 64, xyz, q))
    cnt = ops.unique_neighbor_count(idx)
    _equal(cnt.cpu(), ops.unique_neighbor_count(idx.cpu()))
    counts = set(cnt.flatten().tolist())
    assert 64 in counts and any(1 < c < 64 for c in counts) and (cnt[:, -32:] == 1).all()
    out, got_cnt = ops.uniform_resample_neighbors(idx, torch.Generator(device=dev).manual_seed(0))
    _equal(got_cnt, cnt)
    prefix = torch.arange(64, device=dev) < cnt[..., None]
    assert torch.equal(out[prefix], idx[prefix])
    sorted_idx = idx.sort(dim=-1).values
    hit = torch.searchsorted(sorted_idx.contiguous(), out.contiguous()).clamp(max=63)
    assert torch.equal(sorted_idx.gather(-1, hit), out)  # every draw is one of the row's neighbours


def test_vertex_normals_on_the_card_match_the_cpu(dev):
    from pointnet2_scannet_tpu_torch.utils.normals import compute_vertex_normals

    rng = np.random.default_rng(35)
    verts = rng.uniform(0, 4, (100_000, 3)).astype(np.float32)
    faces = rng.integers(0, 100_000, (200_000, 3))
    np.testing.assert_allclose(compute_vertex_normals(verts, faces, device=dev),
                               compute_vertex_normals(verts, faces, device="cpu"), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", [-1, 2, 4])
def test_virtual_scan_on_the_card_equals_the_cpu(dev, mode):
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene
    from pointnet2_scannet_tpu_torch.utils.scene_util import virtual_scan

    xyz = make_synthetic_scene(0, n_points=40_000)[:, :3]
    got = virtual_scan(xyz, mode, np.random.default_rng(mode + 7), device=dev)
    want = virtual_scan(xyz, mode, np.random.default_rng(mode + 7), device="cpu")
    _equal(got.cpu(), want)


# SSG's SA2-SA4 grouping backwards at batch 2: (J, N, C) of the float32
# [xyz | features] payload and of bfloat16's packed one (xyz_hi, xyz_lo)
SORTED_SCATTER_SHAPES = [(8192, 1024, 67, torch.float32), (2048, 256, 131, torch.float32),
                         (512, 64, 259, torch.float32), (8192, 1024, 70, torch.bfloat16),
                         (2048, 256, 134, torch.bfloat16), (512, 64, 262, torch.bfloat16)]


@pytest.mark.parametrize("j,n,c,dtype", SORTED_SCATTER_SHAPES)
def test_scatter_add_sorted_kernel_equals_the_block_route(dev, j, n, c, dtype):
    g = torch.Generator(device=dev).manual_seed(j + c)
    idx = torch.randint(0, n, (2, j), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::5] = idx[:, :1]
    grad = torch.randn((2, j, c), generator=g, device=dev).to(dtype)
    before = dict(sc.route_launches)
    got = sc.scatter_add_sorted_cuda(idx, grad, n)
    assert sc.route_launches["sort"] == before["sort"] + 1
    _equal(got, sc.scatter_add_cuda(idx, grad, n))
    _equal(got.cpu(), sc.scatter_add_plain(idx.cpu(), grad.cpu(), n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["dense", "cached", "fast"])
def test_interpolation_forms_on_the_card_match_the_cpu(dev, form, dtype):
    from pointnet2_scannet_tpu_torch.ops import interpolate

    fn = interpolate.interpolation(form)
    _, idx = ops.three_nn(_cloud(40, (2, 1024, 3), dev), _cloud(41, (2, 256, 3), dev))
    w = _cloud(42, (2, 1024, 3), dev, 0.1, 1.0)
    w = w / w.sum(-1, keepdim=True)
    feats = torch.randn((2, 256, 64), generator=torch.Generator(device=dev).manual_seed(43), device=dev).to(dtype)
    gout = torch.randn((2, 1024, 64), generator=torch.Generator(device=dev).manual_seed(44), device=dev)

    def run(device):
        x = feats.to(device).clone().requires_grad_(True)
        out = fn(x, idx.to(device), w.to(device))
        return out.detach(), torch.autograd.grad(out, x, gout.to(device, out.dtype))[0]

    kernels.reset_launch_counts()
    card = run(dev)
    counts = kernels.launch_counts()
    assert counts["gather"] == (form == "fast") and counts["scatter_add"] == 0
    for a, e in zip(card, run("cpu")):
        top = float(e.double().abs().max())
        tol = 1e-5 * top if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 6)
        assert a.dtype == e.dtype and float((a.cpu().double() - e.double()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_group_segsum_train_step_on_the_card_equals_the_default(dev, dtype):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, PointNet2Spec
    from pointnet2_scannet_tpu_torch.ops import tuning

    pc = torch.cat([_cloud(1, (2, 256, 3), dev), _cloud(2, (2, 256, 3), dev, -1, 1)], -1)
    batch = {"points": pc, "labels": torch.randint(0, 5, (2, 256), device=dev, dtype=torch.int32,
                                                    generator=torch.Generator(device=dev).manual_seed(3)),
             "weights": torch.ones((2, 256), device=dev)}
    out = {}
    for setting in (False, True):
        saved = tuning.ops_config.group_segsum
        tuning.ops_config.group_segsum = setting
        try:
            model = PointNet2SemSeg(PointNet2Spec(**dict(SMALL_SPECS["ssg"], dropout=0.0)), dtype=dtype,
                                    generator=torch.Generator().manual_seed(0), device=dev)
            state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=0)
            before = dict(sc.route_launches)
            ts.train_step(state, batch, num_classes=5)
            sort = sc.route_launches["sort"] - before["sort"]
        finally:
            tuning.ops_config.group_segsum = saved
        assert sort == (1 if setting else 0)  # SA2's grouping backward
        out[setting] = {k: p.grad.clone() for k, p in model.named_parameters()}
    for k, v in out[False].items():
        _equal(out[True][k], v)
