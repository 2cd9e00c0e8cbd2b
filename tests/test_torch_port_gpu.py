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


@pytest.mark.parametrize(
    "radii,nsamples,n,m",
    [((0.05, 0.1), (16, 32), 8192, 1024), ((0.1, 0.2), (16, 32), 1024, 256),
     ((0.2, 0.4), (16, 32), 256, 64), ((0.4, 0.8), (16, 32), 64, 16),
     ((0.5, 0.15), (40, 8), 300, 77), ((2.0, 0.3), (24, 33), 16, 5)],
)
def test_ball_query_multi_kernel_equals_plain_and_two_single_queries(dev, radii, nsamples, n, m):
    xyz = _cloud(n + m + 1, (3, n, 3), dev)
    q = xyz[:, :m].contiguous()
    q[0, 0] = 10.0  # an empty ball: all zeros in both rows
    before = bqm.launches
    got = bqm.ball_query_multi_cuda(radii, nsamples, xyz, q)
    assert bqm.launches == before + 1
    want = bqm.ball_query_multi_plain(radii, nsamples, xyz, q)
    for g, w, r, k in zip(got, want, radii, nsamples):
        _equal(g, w)
        _equal(g, bq.ball_query_cuda(r, k, xyz, q))


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
        "scatter_add": 0, "ball_query_multi": 1,
    }


# (J, N, C) of every gather gradient of the SSG train step (grouping at SA2-4,
# interpolation at FP0-3), at batch 2
SCATTER_SHAPES = [(8192, 1024, 67), (2048, 256, 131), (512, 64, 259), (24576, 1024, 128),
                  (3072, 256, 256), (768, 64, 256), (192, 16, 512), (40, 7, 3)]


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
    assert all(n > 0 for n in counts.values())
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k
