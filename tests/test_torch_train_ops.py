"""The port's backward ops, train-mode BatchNorm and loss against the JAX
package on the CPU.

Gradients of the gathers must equal the JAX VJPs bit for bit: the port's
plain scatter-add (torch scatter_add_ on the CPU) and XLA's scatter on the
CPU both add in ascending output order from +0.0, the contract the CUDA
kernel (csrc/scatter_add.cu) keeps on the card. Train-mode BatchNorm and the
loss agree to float32 reduction order (XLA and PyTorch sum in different
orders): rtol 1e-5 and atol 1e-5. That bound covers the constant channel of
the BatchNorm test too: there x - mean is a one-ulp roundoff of the mean
that BatchNorm multiplies by rsqrt(eps) ~ 316, and the next layer's
statistics carry it at ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.engine import loss as jloss
from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.ops import interpolate as jinterp
from pointnet2_scannet_tpu.ops.pallas.vmem_gather_kernel import vmem_gather
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.engine import loss
from pointnet2_scannet_tpu_torch.models.layers import PointwiseMLP
from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel
from tests.test_torch_port_model import _load_mlp

RTOL = ATOL = 1e-5  # f32 reduction order, XLA vs PyTorch on the CPU


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _gather_case(seed, c, n=256, j=512, b=2):
    """Source rows, a cotangent with magnitudes over six decades, and indices
    with heavy duplicates and a quarter of the rows never referenced."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, 3 * n // 4, (b, j)).astype(np.int32)
    idx[:, ::5] = idx[:, :1]  # one row referenced ~100 times
    g = (rng.normal(size=(b, j, c)) * 10.0 ** rng.uniform(-3, 3, (b, j, 1))).astype(np.float32)
    return src, idx, g


def _jax_take_vjp(src, idx, g):
    _, vjp = jax.vjp(lambda s: jnp.take_along_axis(s, jnp.asarray(idx)[..., None], axis=1), jnp.asarray(src))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("c", [67, 131, 259, 128])
def test_scatter_and_gather_grad_equal_the_jax_vjps(c):
    src, idx, g = _gather_case(c, c)
    want = _jax_take_vjp(src, idx, g)
    _, pallas_vjp = jax.vjp(lambda s: vmem_gather(s, jnp.asarray(idx), True), jnp.asarray(src))
    want_pallas = np.asarray(pallas_vjp(jnp.asarray(g))[0])
    np.testing.assert_array_equal(_bits(want_pallas), _bits(want))

    plain = scatter_kernel.scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(g), src.shape[1])
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(want))

    x = torch.from_numpy(src).requires_grad_(True)
    out = ops.gather_points(x, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(), np.take_along_axis(src, idx[..., None], 1))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(x.grad.numpy()), _bits(want))
    assert not x.grad[:, 3 * src.shape[1] // 4 :].any()  # unreferenced rows stay 0


def test_group_points_grad_equals_jax():
    from pointnet2_scannet_tpu.ops import neighborhood as jnb

    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 128, 35)).astype(np.float32)
    idx = rng.integers(0, 100, (2, 32, 8)).astype(np.int32)
    g = rng.normal(size=(2, 32, 8, 35)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jnb.group_points(f, jnp.asarray(idx)), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.from_numpy(feats).requires_grad_(True)
    ops.group_points(x, torch.from_numpy(idx)).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(x.grad.numpy()), _bits(want))


@pytest.mark.parametrize("c", [128, 256])
def test_three_interpolate_grad_equals_jax(c):
    rng = np.random.default_rng(c)
    points = rng.normal(size=(2, 64, c)).astype(np.float32)
    idx = rng.integers(0, 48, (2, 256, 3)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]  # a neighbour listed twice
    w = rng.uniform(0.05, 1.0, (2, 256, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    g = rng.normal(size=(2, 256, c)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda p: jinterp.three_interpolate(p, jnp.asarray(idx), jnp.asarray(w)), jnp.asarray(points)
    )
    want = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.from_numpy(points).requires_grad_(True)
    got = ops.three_interpolate(x, torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(x.grad.numpy()), _bits(want))


def _constant_channel_input(shape, seed):
    """Inputs whose channel 0 is the constant 0.1: the layer below copies it
    into its BatchNorm's channel 0, where E[x^2] - E[x]^2 cancels."""
    x = np.random.default_rng(seed).normal(0.3, 1.0, shape).astype(np.float32)
    x[..., 0] = 0.1
    return x


@pytest.mark.parametrize("shape", [(2, 64, 7), (2, 16, 8, 7)], ids=["3d", "4d"])
def test_train_mode_batch_norm_matches_flax(shape):
    from tests.test_torch_port_model import _randomize_bn

    x = _constant_channel_input(shape, len(shape))
    jmlp = jlayers.PointwiseMLP(widths=(12, 6))
    variables = jax.jit(lambda k, a: jmlp.init(k, a, train=False))(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _randomize_bn(variables, len(shape))
    kernel = np.array(variables["params"]["dense_0"]["kernel"])
    variables["params"]["dense_0"]["kernel"] = kernel
    kernel[:, 0] = 0.0
    kernel[0, 0] = 1.0  # BN channel 0 of layer 0 = the constant input channel
    want, mutated = jax.jit(lambda v, a: jmlp.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x)
    )

    pmlp = PointwiseMLP(7, (12, 6))
    _load_mlp(pmlp, variables["params"], variables["batch_stats"])
    pmlp.train()
    xt = torch.from_numpy(x)
    h = pmlp.dense_0(xt)
    dims = tuple(range(h.dim() - 1))
    raw_var = ((h * h).mean(dims) - h.mean(dims) ** 2).detach()
    assert float(raw_var[0]) <= 0.0  # the clip at 0 is what keeps rsqrt finite
    got = pmlp(xt)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for i in (0, 1):
        stats = mutated["batch_stats"][f"bn_{i}"]
        bn = getattr(pmlp, f"bn_{i}")
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=RTOL, atol=ATOL)


def test_train_mode_batch_norm_keeps_the_biased_variance():
    bn_in = np.random.default_rng(3).normal(size=(4, 5, 3)).astype(np.float32)
    mlp = PointwiseMLP(3, (3,))
    with torch.no_grad():
        mlp.dense_0.weight.copy_(torch.eye(3))
    mlp.train()
    mlp(torch.from_numpy(bn_in))
    batch_var = bn_in.reshape(-1, 3).astype(np.float64).var(axis=0)  # ddof=0
    np.testing.assert_allclose(mlp.bn_0.running_var.numpy(), 0.9 + 0.1 * batch_var, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "row_mask"])
def test_weighted_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(4, 100, 20)) * 3).astype(np.float32)
    labels = rng.integers(0, 20, (4, 100)).astype(np.int32)
    weights = rng.uniform(0, 5, (4, 100)).astype(np.float32)
    row_mask = np.array([1, 1, 1, 0], np.float32) if masked else None
    want = jloss.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights),
        None if row_mask is None else jnp.asarray(row_mask),
    )
    got = loss.weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weights),
        None if row_mask is None else torch.from_numpy(row_mask),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    ce_want = jloss.softmax_ce_integer(jnp.asarray(logits), jnp.asarray(labels))
    ce_got = loss.softmax_ce_integer(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(ce_got.numpy(), np.asarray(ce_want), rtol=RTOL, atol=ATOL)
    # the gradient: softmax - onehot, scaled by weight / count
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss.weighted_cross_entropy(
        lt, torch.from_numpy(labels), torch.from_numpy(weights),
        None if row_mask is None else torch.from_numpy(row_mask),
    ).backward()
    gwant = jax.grad(
        lambda z: jloss.weighted_cross_entropy(
            z, jnp.asarray(labels), jnp.asarray(weights),
            None if row_mask is None else jnp.asarray(row_mask),
        )
    )(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gwant), rtol=RTOL, atol=1e-8)
