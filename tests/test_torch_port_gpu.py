"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `gpu`: each test skips without a CUDA device. This file imports
neither jax nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -m gpu

Indices, gathers and squared distances must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.ops import cuda as kernels
from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel as bq,
    fps_kernel as fps,
    gather_kernel as ga,
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


@pytest.mark.parametrize("n,npoint", [(64, 16), (200, 50), (1024, 256), (8192, 1024), (16384, 512)])
@pytest.mark.parametrize("skip", [True, False])
def test_fps_kernel_equals_plain(dev, n, npoint, skip):
    xyz = _cloud(n, (2, n, 3), dev)
    xyz[0, 3] = 0.0  # near the origin
    xyz[1, n // 2:] = xyz[1, : n - n // 2].clone()  # duplicates: exact ties
    before = fps.launches
    _equal(fps.furthest_point_sample_cuda(xyz, npoint, skip_near_origin=skip),
           fps.furthest_point_sample_plain(xyz, npoint, skip_near_origin=skip))
    assert fps.launches == before + 1


def test_fps_kernel_refuses_too_many_points(dev):
    with pytest.raises(ValueError, match="N <="):
        fps.furthest_point_sample_cuda(torch.zeros((1, fps.MAX_POINTS + 1, 3), device=dev), 4)


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


@pytest.mark.parametrize("c", [3, 9, 67, 131, 259])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_kernel_equals_plain(dev, c, dtype):
    g = torch.Generator(device=dev).manual_seed(c)
    if dtype == torch.float32:
        src = torch.randn((2, 300, c), generator=g, device=dev)
    else:
        src = torch.randint(-2**31, 2**31 - 1, (2, 300, c), generator=g, device=dev, dtype=dtype)
    idx = torch.randint(0, 300, (2, 1000), generator=g, device=dev, dtype=torch.int32)
    _equal(ga.gather_cuda(src, idx), ga.gather_plain(src, idx))


def test_gather_kernel_is_forward_only(dev):
    src = torch.zeros((1, 8, 3), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        ga.gather_cuda(src, torch.zeros((1, 2), dtype=torch.int32, device=dev))
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


def test_small_model_on_the_card_matches_the_cpu(dev):
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, PointNet2Spec

    spec = PointNet2Spec(
        num_classes=5, input_channels=3, npoints=(64, 16), radii=((0.3,), (0.6,)),
        nsamples=((8,), (8,)), sa_mlps=(((8, 8, 16),), ((16, 16, 32),)),
        fp_mlps=((16, 16), (32, 16)), cls_fc=(16,),
    )
    model = PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(0))
    pc = torch.cat([_cloud(1, (2, 256, 3), "cpu"), _cloud(2, (2, 256, 3), "cpu", -1, 1)], -1)
    with torch.inference_mode():
        want = model(pc)
        kernels.reset_launch_counts()
        got = model.to(dev)(pc.to(dev)).cpu()
    assert all(n > 0 for n in kernels.launch_counts().values())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)  # f32 matmul order


def test_public_ops_launch_the_kernels(dev):
    xyz = _cloud(3, (2, 512, 3), dev)
    kernels.reset_launch_counts()
    idx = ops.furthest_point_sample(xyz[:, :, :], 64)
    new_xyz = ops.gather_points(xyz, idx)
    ops.query_and_group(0.2, 16, xyz, new_xyz, xyz)
    ops.three_nn(xyz, new_xyz)
    assert kernels.launch_counts() == {
        "furthest_point_sample": 1, "ball_query": 1, "gather": 2, "three_nn": 1,
    }
