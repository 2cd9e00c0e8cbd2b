"""The port's SSG model against the JAX package's on the CPU.

JAX-initialised variables (with randomised BatchNorm statistics, so a
swapped mapping cannot pass) move into the port through
models/convert.state_dict_from_jax and a strict load; both packages then run
the same numpy inputs in eval mode. Logits agree to rtol 1e-4, atol 1e-4:
the float32 matrix products sum in another order in XLA and in PyTorch's CPU
BLAS, while every index the ops produce is identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.models import modules as jmodules
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu_torch.models import convert, modules, pointnet2

SMALL = dict(
    num_classes=5,
    input_channels=3,
    npoints=(64, 16),
    radii=((0.3,), (0.6,)),
    nsamples=((8,), (8,)),
    sa_mlps=(((8, 8, 16),), ((16, 16, 32),)),
    fp_mlps=((16, 16), (32, 16)),
    cls_fc=(16,),
)
RTOL = ATOL = 1e-4  # f32 matmul summation order (XLA vs PyTorch CPU BLAS)


def _randomize_bn(variables, seed):
    """Non-trivial BatchNorm scale/bias/mean/var, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for name in p:
            if name.startswith("bn_"):
                w = p[name]["scale"].shape[0]
                p[name] = {
                    "scale": rng.uniform(0.5, 1.5, w).astype(np.float32),
                    "bias": rng.normal(0, 0.1, w).astype(np.float32),
                }
                s[name] = {
                    "mean": rng.normal(0, 0.1, w).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, w).astype(np.float32),
                }
            elif isinstance(p[name], dict):
                walk(p[name], s.setdefault(name, {}))

    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    out = {"params": _to_dict(out["params"]), "batch_stats": _to_dict(out["batch_stats"])}
    walk(out["params"], out["batch_stats"])
    return out


def _to_dict(tree):
    return {k: _to_dict(v) if hasattr(v, "keys") else v for k, v in tree.items()}


def _both(spec_kwargs, batch, n, seed):
    jspec = jmodel.PointNet2Spec(**spec_kwargs)
    pspec = pointnet2.PointNet2Spec(**spec_kwargs)
    rng = np.random.default_rng(seed)
    pc = np.concatenate(
        [rng.uniform(0, 1.5, (batch, n, 3)), rng.normal(0, 0.5, (batch, n, jspec.input_channels))],
        axis=-1,
    ).astype(np.float32)
    jm = jmodel.PointNet2SemSeg(spec=jspec)
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = _randomize_bn(init(jax.random.PRNGKey(seed), jnp.asarray(pc)), seed)
    pm = pointnet2.PointNet2SemSeg(pspec)
    state = convert.state_dict_from_jax(variables, pspec)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return jm, variables, pm, pc


@pytest.mark.parametrize("which", ["small", "ssg", "msg"])
def test_state_dict_from_jax_covers_every_tensor(which):
    specs = {"ssg": jmodel.ssg_spec, "msg": jmodel.msg_spec}
    kwargs = SMALL if which == "small" else dataclasses.asdict(specs[which](20, 6))
    spec = pointnet2.PointNet2Spec(**kwargs)
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**kwargs))
    x = jnp.zeros((1, 128, 3 + spec.input_channels), jnp.float32)
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), variables)
    state = convert.state_dict_from_jax(variables, spec)
    model = pointnet2.PointNet2SemSeg(spec)
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables))
    n_port = sum(v.numel() for k, v in want.items() if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port


def test_small_spec_logits_match_jax():
    jm, variables, pm, pc = _both(SMALL, batch=2, n=256, seed=3)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    assert got.shape == (2, 256, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ssg_spec_logits_match_jax():
    kwargs = dataclasses.asdict(jmodel.ssg_spec(20, 6))
    jm, variables, pm, pc = _both(kwargs, batch=2, n=2048, seed=4)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    assert got.shape == (2, 2048, 20)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


def _module_vars(jmod, args, seed):
    variables = jax.jit(lambda k, *a: jmod.init(k, *a, train=False))(jax.random.PRNGKey(seed), *args)
    return _randomize_bn(variables, seed)


def _load_mlp(pmlp, node, stats):
    state = {}
    for name, leaf in node.items():
        if name.startswith("dense_"):
            state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(leaf["kernel"].T))
        else:
            state[f"{name}.weight"] = torch.from_numpy(leaf["scale"])
            state[f"{name}.bias"] = torch.from_numpy(leaf["bias"])
            state[f"{name}.running_mean"] = torch.from_numpy(stats[name]["mean"])
            state[f"{name}.running_var"] = torch.from_numpy(stats[name]["var"])
            state[f"{name}.num_batches_tracked"] = torch.tensor(0)
    pmlp.load_state_dict(state, strict=True)


def test_set_abstraction_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, 6)).astype(np.float32)
    jsa = jmodules.SetAbstraction(npoint=64, radii=(0.3,), nsamples=(16,), mlps=((16, 32),))
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    v = _module_vars(jsa, args, 5)
    want_xyz, want_f, _ = jax.jit(lambda v, *a: jsa.apply(v, *a, train=False))(v, *args)
    psa = modules.SetAbstraction(64, (0.3,), (16,), ((16, 32),), 6)
    _load_mlp(psa.mlp_0, v["params"]["mlp_0"], v["batch_stats"]["mlp_0"])
    psa.eval()
    with torch.inference_mode():
        got_xyz, got_f = psa(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=RTOL, atol=ATOL)


def test_feature_propagation_matches_jax():
    rng = np.random.default_rng(6)
    unknown = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    known = unknown[:, :64].copy()
    uf = rng.normal(size=(2, 256, 8)).astype(np.float32)
    kf = rng.normal(size=(2, 64, 16)).astype(np.float32)
    jfp = jmodules.FeaturePropagation(mlp=(32, 16))
    args = tuple(map(jnp.asarray, (unknown, known, uf, kf)))
    v = _module_vars(jfp, args, 6)
    want = jax.jit(lambda v, *a: jfp.apply(v, *a, train=False))(v, *args)
    pfp = modules.FeaturePropagation((32, 16), 24)
    _load_mlp(pfp.mlp, v["params"]["mlp"], v["batch_stats"]["mlp"])
    pfp.eval()
    with torch.inference_mode():
        got = pfp(*map(torch.from_numpy, (unknown, known, uf, kf)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_generator_init_is_seeded_he_normal():
    a, b, c = (pointnet2.get_model(20, is_msg=False, input_channels=6,
                                   generator=torch.Generator().manual_seed(seed))
               for seed in (7, 7, 8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["fp_0.mlp.dense_0.weight"]  # (128, 134)
    assert not torch.equal(w, sc["fp_0.mlp.dense_0.weight"])
    assert abs(float(w.std()) - (2.0 / w.shape[1]) ** 0.5) < 0.1 * (2.0 / w.shape[1]) ** 0.5
    assert float(w.abs().max()) <= 2 * (2.0 / w.shape[1]) ** 0.5 / 0.87962566103423978


def test_get_model_builds_msg_by_default_with_the_jax_parameter_count():
    model = pointnet2.get_model(20)  # is_msg=True, as in the JAX package
    assert model.spec == pointnet2.PointNet2Spec(**dataclasses.asdict(jmodel.msg_spec(20, 6)))
    assert pointnet2.get_model(20, is_msg=True).spec == model.spec
    jm = jmodel.get_model(20)
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 9)), train=False))
    n_params = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables["params"]))
    n_stats = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables["batch_stats"]))
    assert sum(p.numel() for p in model.parameters()) == n_params
    assert sum(b.numel() for k, b in model.named_buffers() if b.is_floating_point()) == n_stats
