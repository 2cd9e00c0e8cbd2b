"""The port's MSG slice against the JAX package on the CPU.

- ball_query_multi (the fused two-radius query, kernel c's plain version)
  equals, bit for bit, the interpret-mode Pallas ball_query_multi_pallas
  where that kernel takes the shape, the JAX single-radius op per scale, and
  the port's own single-radius ball_query.
- PointwiseMLP.pregather (layer 0 before the gather) against the JAX
  PointwiseMLPPregather and against the port's unfused forward of the same
  parameters:
  values and gradients to 1e-10 in float64 and 1e-5 in float32, where the
  two compositions sum in another order.
- A two-scale SetAbstraction against the JAX one in eval mode, with the
  pregather gate on and off.
- A small MSG model (whose second level takes the pregather in float32) and
  msg_spec(20, 6) at B = 2, N = 2048: logits against the JAX model at
  rtol = atol = 1e-4 (float32 matmul order; every index is identical).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.models import modules as jmodules
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.ops import neighborhood as jnb
from pointnet2_scannet_tpu.ops.pallas.ball_query_kernel import ball_query_multi_pallas
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.models import layers, modules, pointnet2
from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm
from tests import oracles
from tests.test_torch_port_model import RTOL, ATOL, _both, _load_mlp, _module_vars

# a small MSG model: SA2's c_in = 16 + 16 + 3 = 35 >= 2 * 16, so in float32
# it takes the pregather composition, as msg_spec's SA3 and SA4 do
SMALL_MSG = dict(
    num_classes=5,
    input_channels=3,
    npoints=(64, 16),
    radii=((0.2, 0.4), (0.4, 0.8)),
    nsamples=((8, 16), (8, 16)),
    sa_mlps=(((8, 8, 16), (8, 16, 16)), ((16, 16, 32), (16, 24, 32))),
    fp_mlps=((16, 16), (32, 16)),
    cls_fc=(16,),
)
# float32 bound of the pregather against the unfused composition and the
# JAX module: the split layer 0 sums its products in another order
PREGATHER_TOL = {"float64": 1e-10, "float32": 1e-5}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, shape, lo=0.0, hi=1.5):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


@contextlib.contextmanager
def _x64(enabled: bool):
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


# ------------------------------------------------- two-radius ball query


def _random_case():
    xyz = _cloud(70, (2, 256, 3))
    return xyz, xyz[:, :64].copy(), (0.2, 0.4), (16, 32)


def _descending_case():
    xyz, q, _, _ = _random_case()
    return xyz, q, (0.5, 0.15), (32, 8)


def _boundary_case():
    # points at exactly d^2 == f32(r)^2 of each radius are outside it; one
    # ulp closer is inside; query 1 sees an empty ball, query 2 a short row
    r1, r2 = np.float32(0.25), np.float32(0.5)
    xyz = np.full((1, 128, 3), 3.0, np.float32)
    xyz[0, 3] = [r1, 0, 0]
    xyz[0, 4] = [np.nextafter(r1, np.float32(0)), 0, 0]
    xyz[0, 7] = [r2, 0, 0]
    xyz[0, 9] = [0, np.nextafter(r2, np.float32(0)), 0]
    xyz[0, 90] = [10.0, 10.02, 10.0]
    q = np.array([[[0, 0, 0], [-5, -5, -5], [10, 10, 10]]], np.float32)
    return xyz, q, (0.25, 0.5), (4, 8)


def _fewer_points_case():
    # N < k: every point is a hit and the tail repeats the first hit
    xyz = _cloud(71, (2, 16, 3))
    return xyz, xyz[:, :4].copy(), (0.3, 2.0), (24, 32)


BQM_CASES = {
    "random": _random_case,
    "descending_radii": _descending_case,
    "radius_boundary_empty_and_short": _boundary_case,
    "fewer_points_than_samples": _fewer_points_case,
}


@pytest.mark.parametrize("case", sorted(BQM_CASES))
def test_ball_query_multi_matches_pallas_jax_and_single_queries(case):
    xyz, q, radii, nsamples = BQM_CASES[case]()
    got = ops.ball_query_multi(radii, nsamples, _t(xyz), _t(q))
    assert len(got) == 2
    n = xyz.shape[1]
    if n % 128 == 0:  # the shapes the Pallas kernel takes
        want = ball_query_multi_pallas(radii, nsamples, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, r, k in zip(got, radii, nsamples):
        assert g.dtype == torch.int32 and g.shape == (q.shape[0], q.shape[1], k)
        np.testing.assert_array_equal(g.numpy(), ops.ball_query(r, k, _t(xyz), _t(q)).numpy())
        np.testing.assert_array_equal(g.numpy(), oracles.ball_query_oracle(r, k, xyz, q))
        if k <= n:  # the JAX op's top_k refuses k > N
            want = jnb.ball_query(r, k, jnp.asarray(xyz), jnp.asarray(q), use_pallas=False)
            np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    if case == "radius_boundary_empty_and_short":
        np.testing.assert_array_equal(got[0][0, 0], [4, 4, 4, 4])
        np.testing.assert_array_equal(got[1][0, 0], [3, 4, 9, 3, 3, 3, 3, 3])
        assert not got[0][0, 1].any() and not got[1][0, 1].any()  # empty ball
        np.testing.assert_array_equal(got[1][0, 2], [90] * 8)


def test_ball_query_multi_refuses_other_than_two_scales():
    xyz = _t(_cloud(72, (1, 32, 3)))
    with pytest.raises(ValueError, match="two radii"):
        bqm.ball_query_multi_plain((0.1, 0.2, 0.3), (4, 4, 4), xyz, xyz)
    with pytest.raises(ValueError, match="two radii"):
        ops.ball_query_multi((0.1,), (4, 8), xyz, xyz)


# ------------------------------------------------------------ pregather


def _pregather_inputs(seed, dtype, n=128, m=32, k=8, c=24):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1, (2, n, 3))
    new_xyz = xyz[:, :m].copy()
    feats = rng.normal(size=(2, n, c))
    idx = ops.ball_query(0.3, k, _t(xyz.astype(np.float32)), _t(new_xyz.astype(np.float32))).numpy()
    return xyz.astype(dtype), feats.astype(dtype), idx, new_xyz.astype(dtype), rng


def _port_mlp_from_jax(variables, widths, c_in, dtype):
    mlp = layers.PointwiseMLP(c_in, widths)
    _load_mlp(mlp, variables["params"], variables["batch_stats"])
    return mlp.to(getattr(torch, dtype)).eval()


def _port_outputs(mlp, fused, xyz, feats, idx, new_xyz, g):
    """Train-mode output, its gradients (parameters and inputs) for the
    cotangent g, and the eval-mode output (taken first: a train-mode
    forward moves the running statistics)."""

    def run(x, f, i, c):
        return mlp.pregather(x, f, i, c) if fused else mlp(ops.group_with_idx(i, x, c, f))

    with torch.no_grad():
        ev = run(*map(_t, (xyz, feats, idx, new_xyz)))
    mlp.train()
    x, f, c = (_t(a).requires_grad_(True) for a in (xyz, feats, new_xyz))
    out = run(x, f, _t(idx), c)
    (out * _t(g)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in mlp.named_parameters()}
    grads.update(xyz=x.grad.numpy(), features=f.grad.numpy(), new_xyz=c.grad.numpy())
    return out.detach().numpy(), grads, ev.numpy()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pointwise_mlp_pregather_matches_jax_and_the_unfused_mlp(dtype):
    widths = (16, 24, 32)
    xyz, feats, idx, new_xyz, rng = _pregather_inputs(80, dtype)
    c_in = 3 + feats.shape[-1]
    g = rng.normal(size=(*idx.shape, widths[-1])).astype(dtype)
    jm = jlayers.PointwiseMLPPregather(widths)
    args32 = tuple(jnp.asarray(a, jnp.float32) if a.dtype != np.int32 else jnp.asarray(a)
                   for a in (xyz, feats, idx, new_xyz))
    variables = _module_vars(jm, args32, 80)
    tol = PREGATHER_TOL[dtype]

    with _x64(dtype == "float64"):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), variables)
        jargs = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(new_xyz))

        def loss(params, x, f, c):
            out, _ = jm.apply({"params": params, "batch_stats": jvars["batch_stats"]}, x, f,
                              jargs[2], c, True, mutable=["batch_stats"])
            return jnp.sum(out * g), out

        (_, j_train), j_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            jvars["params"], jargs[0], jargs[1], jargs[3])
        j_eval = jax.jit(lambda v, *a: jm.apply(v, *a, False))(jvars, *jargs)
        j_params, j_x, j_f, j_c = jax.tree_util.tree_map(np.asarray, j_grads)

    mlp = _port_mlp_from_jax(variables, widths, c_in, dtype)
    fused = _port_outputs(mlp, True, xyz, feats, idx, new_xyz, g)
    mlp = _port_mlp_from_jax(variables, widths, c_in, dtype)
    unfused = _port_outputs(mlp, False, xyz, feats, idx, new_xyz, g)

    want_grads = {"xyz": j_x, "features": j_f, "new_xyz": j_c}
    for name, node in j_params.items():
        for leaf, value in node.items():
            key = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
            want_grads[f"{name}.{key}"] = value.T if leaf == "kernel" else value
    for got_train, got_grads, got_eval in (fused, unfused):
        np.testing.assert_allclose(got_train, np.asarray(j_train), rtol=tol, atol=tol)
        np.testing.assert_allclose(got_eval, np.asarray(j_eval), rtol=tol, atol=tol)
        assert set(got_grads) == set(want_grads)
        for k, want in want_grads.items():
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got_grads[k], want, rtol=tol, atol=tol * scale, err_msg=k)


def test_pregather_mlp_has_the_pointwise_mlp_parameters():
    # the split layer 0 is views of dense_0's weight: the gradients of its
    # xyz and feature columns land in that one parameter, and no parameter
    # of the MLP is left out
    xyz, feats, idx, new_xyz, _ = _pregather_inputs(81, "float32", c=24)
    mlp = layers.PointwiseMLP(27, (16, 32))
    assert set(mlp.state_dict()) == {
        f"{m}_{i}.{k}" for i in range(2) for m, ks in
        (("dense", ("weight",)), ("bn", ("weight", "bias", "running_mean", "running_var",
                                         "num_batches_tracked"))) for k in ks}
    mlp.pregather(*map(_t, (xyz, feats, idx, new_xyz))).sum().backward()
    for name, p in mlp.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape, name
    w = mlp.dense_0.weight.grad
    assert bool(w[:, :3].abs().sum() > 0) and bool(w[:, 3:].abs().sum() > 0)


# ------------------------------------------------------ set abstraction


@pytest.mark.parametrize("gate", ["pregather", "unfused"])
def test_two_scale_set_abstraction_matches_jax(gate):
    # c_in = 3 + 29 = 32: widths[0] = 16 engages the pregather, 24 does not
    w0 = 16 if gate == "pregather" else 24
    mlps = ((w0, 32), (w0, 24, 16))
    rng = np.random.default_rng(90)
    xyz = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, 29)).astype(np.float32)
    jsa = jmodules.SetAbstraction(npoint=64, radii=(0.4, 0.2), nsamples=(16, 8), mlps=mlps)
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    v = _module_vars(jsa, args, 90)
    want_xyz, want_f, _ = jax.jit(lambda v, *a: jsa.apply(v, *a, train=False))(v, *args)
    psa = modules.SetAbstraction(64, (0.4, 0.2), (16, 8), mlps, 29)
    for s in range(2):
        _load_mlp(getattr(psa, f"mlp_{s}"), v["params"][f"mlp_{s}"], v["batch_stats"][f"mlp_{s}"])
    psa.eval()
    assert psa.out_channels == 48
    assert psa._pregather(_t(feats), mlps[0]) == (gate == "pregather")
    assert not psa._pregather(_t(feats).double(), mlps[0])  # never in float64
    with torch.inference_mode():
        got_xyz, got_f = psa(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got_f.shape == (2, 64, 48)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- model


def _model(spec_kwargs):
    return pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**spec_kwargs))


def _logits(spec_kwargs, batch, n, seed):
    jm, variables, pm, pc = _both(spec_kwargs, batch=batch, n=n, seed=seed)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    return got, want


def test_small_msg_spec_logits_match_jax():
    model = _model(SMALL_MSG)
    assert not model.sa_0._pregather(torch.zeros(1, 1, 3), model.sa_0.mlp_0.widths)
    assert model.sa_1._pregather(torch.zeros(1, 1, 32), model.sa_1.mlp_0.widths)
    got, want = _logits(SMALL_MSG, batch=2, n=256, seed=7)
    assert got.shape == (2, 256, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_msg_spec_logits_match_jax():
    got, want = _logits(dataclasses.asdict(jmodel.msg_spec(20, 6)), batch=2, n=2048, seed=8)
    assert got.shape == (2, 2048, 20)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999
