"""The port's votenet modules, RandomDropout and bn_momentum against the
JAX package on the CPU.

Inputs are drawn with numpy from seeds; the JAX modules' variables are drawn
with numpy on their init trees (BatchNorm scale, bias, mean and var away
from their identity values, so a swapped mapping cannot pass) and moved into
the port by models/convert.module_state_dict_from_jax (or
state_dict_from_jax for a model) with a strict load. Float outputs and moved
BatchNorm statistics agree to rtol = atol = 1e-4 in float32, the port's
model tolerance (tests/test_torch_port_model.py): the matrix products sum in
another order in XLA and in PyTorch's CPU BLAS. Indices and counts are equal.

- unique_neighbor_count equals the JAX function on ball-query rows with
  empty, short and full balls; uniform_resample_neighbors keeps each row's
  distinct prefix, draws the padding from it, and draws it uniformly.
- SetAbstractionVotes in each pooling (max, avg, rbf), eval and train, with
  normalize_xyz, ret_unique_cnt and the inds passthrough, and at group-all;
  with sample_uniformly on a cloud where every ball is full (the resampling
  changes nothing there, so the port must equal the JAX module).
- SetAbstractionMSGVotes and LearnableFeaturePropagationMSG, eval and train
  (LFP's one post_mlp moves its statistics once a scale).
- RandomDropout: identity in eval mode; no rescale, a kept share in
  [1 - p, 1].
- bn_momentum 0.9 / 0.5 / 0.0, from BNMomentumScheduler, on PointwiseMLP,
  FC and a small SSG model against the JAX EMA; None and a 0-d tensor give
  what 0.9 and the float give, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.models import modules as jmodules
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.ops import ball_query as jball_query
from pointnet2_scannet_tpu.ops.neighborhood import unique_neighbor_count as junique_count
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.models import convert, layers, modules, pointnet2
from tests.test_torch_cls_partseg import _draw
from tests.test_torch_port_model import SMALL

RTOL = ATOL = 1e-4  # the port's model tolerance: f32 matmul order (XLA vs PyTorch CPU BLAS)
B, N, M = 2, 256, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(seed: int, n: int = N, c: int = 4, lo: float = -1.0, hi: float = 1.0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(lo, hi, (B, n, 3)).astype(np.float32)
    feats = rng.normal(0, 1.0, (B, n, c)).astype(np.float32)
    return xyz, feats


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _pair(jmod, pmod, seed: int, *args, rngs=None):
    """The JAX module's numpy-drawn variables, also loaded into pmod."""
    keys = {"params": jax.random.PRNGKey(0), **(rngs or {})}
    tree = jax.eval_shape(lambda *a: jmod.init(keys, *a), *args)
    variables = _draw(tree, seed)
    state = convert.module_state_dict_from_jax(variables)
    pmod.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return variables


def _apply(jmod, variables, args, train: bool, rngs=None):
    """The JAX module's outputs, and its moved batch_stats in train mode."""
    if train:
        out, mutated = jmod.apply(variables, *args, train=True, mutable=["batch_stats"], rngs=rngs)
        return out, {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    return jmod.apply(variables, *args, train=False, rngs=rngs), None


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _stats_close(pmod, moved):
    """The port's running statistics against the JAX module's moved ones."""
    want = convert.module_state_dict_from_jax(moved)
    got = pmod.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _ball_rows():
    """Ball-query rows (B, 64, 16) of a clustered cloud: empty balls (queries
    far away), short balls and full balls."""
    rng = np.random.default_rng(5)
    xyz = np.concatenate([rng.normal(0, 0.05, (B, 96, 3)), rng.uniform(-1, 1, (B, 160, 3))], 1).astype(np.float32)
    q = np.concatenate([xyz[:, :24], xyz[:, 96:120], rng.uniform(5, 6, (B, 16, 3))], 1).astype(np.float32)
    idx = ops.ball_query(0.2, 16, _t(xyz), _t(q))
    return xyz, q, idx


def test_unique_neighbor_count_equals_jax():
    xyz, q, idx = _ball_rows()
    want = np.asarray(jball_query(0.2, 16, jnp.asarray(xyz), jnp.asarray(q)))
    np.testing.assert_array_equal(idx.numpy(), want)
    cnt = ops.unique_neighbor_count(idx)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(junique_count(jnp.asarray(want))))
    counts = set(cnt.flatten().tolist())
    assert 16 in counts and any(1 < c < 16 for c in counts)  # full and short balls
    assert (cnt[:, 48:] == 1).all() and (idx[:, 48:] == 0).all()  # empty balls count as one


def test_uniform_resample_neighbors_invariants():
    _, _, idx = _ball_rows()
    gen = torch.Generator().manual_seed(3)
    out, cnt = ops.uniform_resample_neighbors(idx, gen)
    assert out.dtype == cnt.dtype == torch.int32
    assert torch.equal(cnt, ops.unique_neighbor_count(idx))
    k = torch.arange(idx.shape[-1])
    prefix = k < cnt[..., None]
    assert torch.equal(out[prefix], idx[prefix])
    for b, m in zip(*np.nonzero((cnt < 16).numpy())):
        assert set(out[b, m].tolist()) <= set(idx[b, m, : cnt[b, m]].tolist())
    # uniformity: 4 distinct neighbours, 60 padded slots a row, 500 rows
    row = torch.tensor([3, 7, 9, 12] + [3] * 60, dtype=torch.int32)
    draws, _ = ops.uniform_resample_neighbors(row.expand(1, 500, 64).contiguous(), gen)
    freq = torch.bincount(draws[..., 4:].flatten().long(), minlength=13)[[3, 7, 9, 12]].double() / (500 * 60)
    assert float((freq - 0.25).abs().max()) < 0.02  # 7500 draws a value: sd 0.0025


VOTES_CASES = {  # pooling: (normalize_xyz, inds given)
    "max": (False, False),
    "avg": (True, True),
    "rbf": (True, True),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("pooling", list(VOTES_CASES))
def test_sa_votes_matches_jax(pooling, train):
    normalize, given = VOTES_CASES[pooling]
    xyz, feats = _cloud(11)
    inds = np.random.default_rng(2).permutation(N)[:M][None].repeat(B, 0).astype(np.int32) if given else None
    kw = dict(npoint=M, radius=0.4, nsample=16, pooling=pooling, normalize_xyz=normalize, ret_unique_cnt=True)
    jm = jmodules.SetAbstractionVotes(mlp=(8, 16), **kw)
    pm = modules.SetAbstractionVotes((8, 16), 4, **kw).train(train)
    variables = _pair(jm, pm, 21, xyz, feats, inds)
    (jxyz, jfeat, jinds, jcnt), moved = _apply(jm, variables, (xyz, feats, inds), train)
    pxyz, pfeat, pinds, pcnt = pm(_t(xyz), _t(feats), _t(inds))
    np.testing.assert_array_equal(pinds.numpy(), np.asarray(jinds))
    np.testing.assert_array_equal(pcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(pxyz.numpy(), np.asarray(jxyz))
    assert pfeat.shape == (B, M, 16)
    _close(pfeat, jfeat)
    if train:
        _stats_close(pm, moved)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sa_votes_group_all_matches_jax(train):
    xyz, feats = _cloud(12, n=64)
    jm = jmodules.SetAbstractionVotes(mlp=(8, 16))
    pm = modules.SetAbstractionVotes((8, 16), 4).train(train)
    variables = _pair(jm, pm, 22, xyz, feats)
    (jxyz, jfeat, jinds), moved = _apply(jm, variables, (xyz, feats), train)
    pxyz, pfeat, pinds = pm(_t(xyz), _t(feats))
    assert pxyz is None and pinds is None and jxyz is None and jinds is None
    assert pfeat.shape == (B, 1, 16)
    _close(pfeat, jfeat)
    if train:
        _stats_close(pm, moved)


def test_sa_votes_sample_uniformly_on_full_balls_matches_jax():
    """Every ball holds more than nsample points, so there is no padding to
    resample: the port's generator and JAX's key must both leave idx as the
    ball query gave it."""
    xyz, feats = _cloud(13, lo=0.0)
    kw = dict(npoint=M, radius=0.5, nsample=8, sample_uniformly=True, ret_unique_cnt=True)
    jm = jmodules.SetAbstractionVotes(mlp=(8, 16), **kw)
    pm = modules.SetAbstractionVotes((8, 16), 4, **kw).train()
    rngs = {"sample": jax.random.PRNGKey(4)}
    variables = _pair(jm, pm, 23, xyz, feats, rngs=rngs)
    (_, jfeat, _, jcnt), moved = _apply(jm, variables, (xyz, feats), True, rngs=rngs)
    _, pfeat, _, pcnt = pm(_t(xyz), _t(feats), generator=torch.Generator().manual_seed(4))
    assert (pcnt == 8).all()
    np.testing.assert_array_equal(pcnt.numpy(), np.asarray(jcnt))
    _close(pfeat, jfeat)
    _stats_close(pm, moved)
    with pytest.raises(ValueError, match="Generator"):
        pm(_t(xyz), _t(feats))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sa_msg_votes_matches_jax(train):
    xyz, feats = _cloud(14)
    inds = np.random.default_rng(6).permutation(N)[:M][None].repeat(B, 0).astype(np.int32)
    kw = dict(npoint=M, radii=(0.2, 0.4), nsamples=(8, 16))
    jm = jmodules.SetAbstractionMSGVotes(mlps=((8, 16), (8, 32)), **kw)
    pm = modules.SetAbstractionMSGVotes(mlps=((8, 16), (8, 32)), in_channels=4, **kw).train(train)
    variables = _pair(jm, pm, 24, xyz, feats, inds)
    (jxyz, jfeat, jinds), moved = _apply(jm, variables, (xyz, feats, inds), train)
    pxyz, pfeat, pinds = pm(_t(xyz), _t(feats), _t(inds))
    np.testing.assert_array_equal(pinds.numpy(), inds)
    np.testing.assert_array_equal(pxyz.numpy(), np.asarray(jxyz))
    assert pfeat.shape == (B, M, 48)
    _close(pfeat, jfeat)
    if train:
        _stats_close(pm, moved)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lfp_msg_matches_jax(train):
    """In train mode the shared post_mlp's statistics move once a scale:
    one post_mlp a scale would give other running statistics."""
    xyz1, f1 = _cloud(15)
    xyz2, f2 = _cloud(16, n=M, c=6)
    kw = dict(mlps=((8, 16), (8, 16)), radii=(0.3, 0.6), nsamples=(8, 16), post_mlp=(12,))
    jm = jmodules.LearnableFeaturePropagationMSG(**kw)
    pm = modules.LearnableFeaturePropagationMSG(**kw, in_channels1=4, in_channels2=6).train(train)
    args = (xyz2, xyz1, f2, f1)
    variables = _pair(jm, pm, 25, *args)
    want, moved = _apply(jm, variables, args, train)
    got = pm(*map(_t, args))
    assert got.shape == (B, M, 24)
    _close(got, want)
    if train:
        _stats_close(pm, moved)


def test_random_dropout():
    x = torch.ones(64, 256)
    drop = layers.RandomDropout(0.5)
    gen = torch.Generator().manual_seed(0)
    assert drop.eval()(x, gen) is x  # eval mode: identity, no draw
    assert layers.RandomDropout(0.0).train()(x, gen) is x
    drop.train()
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    kept = [float(drop(x, gen).mean()) for _ in range(20)]  # values stay 1: no rescale
    assert all(0.5 - 0.02 <= k <= 1.0 for k in kept)  # 16384 draws: sd 0.004 at theta = p
    assert len({round(k, 3) for k in kept}) > 1  # a new rate every call
    y = drop(x * 3.0, gen)
    assert set(y.unique().tolist()) <= {0.0, 3.0}


# torch-convention momenta by epoch: the flax ones are 0.9, 0.5, 0.0
SCHEDULE = layers.BNMomentumScheduler(lambda epoch: (0.1, 0.5, 1.0)[epoch])
MOMENTA = [pytest.approx(m) for m in (0.9, 0.5, 0.0)]


def _momentum_runs(run):
    """run(bn_momentum) -> moved statistics, for the schedule's three epochs,
    each against the JAX EMA; None must give 0.9's bits and a 0-d tensor
    the float's."""
    sched = layers.BNMomentumScheduler(SCHEDULE.lmbd)
    momenta = [sched.step() for _ in range(3)]
    assert momenta == MOMENTA and sched.last_epoch == 2
    for m in momenta:
        run(m)
    for a, b in ((None, 0.9), (torch.tensor(0.5), 0.5)):
        ga, gb = run(a, compare=False), run(b, compare=False)
        assert all(torch.equal(ga[k], gb[k]) for k in ga)


def _moved(pm):
    return {k: v.clone() for k, v in pm.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def test_bn_momentum_on_pointwise_mlp_and_fc_matches_jax():
    rng = np.random.default_rng(9)
    x3 = rng.normal(2.0, 3.0, (4, 16, 3)).astype(np.float32)
    x2 = rng.normal(1.0, 2.0, (16, 12)).astype(np.float32)
    for jm, pm, x in ((jlayers.PointwiseMLP((6, 8)), layers.PointwiseMLP(3, (6, 8)), x3),
                      (jlayers.FC(out_size=5, bn=True), layers.FC(12, 5, bn=True), x2)):
        variables = _pair(jm, pm, 26, x)
        pm.train()
        state = {k: v.clone() for k, v in pm.state_dict().items()}

        def run(m, compare=True, jm=jm, pm=pm, x=x, variables=variables, state=state):
            pm.load_state_dict(state)
            got = pm(torch.from_numpy(x), bn_momentum=m)
            if compare:
                want, mutated = jm.apply(variables, x, True, m, mutable=["batch_stats"])
                _close(got, want)
                _stats_close(pm, {"params": variables["params"], "batch_stats": mutated["batch_stats"]})
            return _moved(pm)

        _momentum_runs(run)


def test_bn_momentum_on_ssg_model_matches_jax():
    spec = dict(SMALL, dropout=0.0)
    jspec, pspec = jmodel.PointNet2Spec(**spec), pointnet2.PointNet2Spec(**spec)
    rng = np.random.default_rng(10)
    pc = np.concatenate([rng.uniform(0, 1.5, (B, 128, 3)), rng.normal(0, 0.5, (B, 128, 3))], -1).astype(np.float32)
    jm = jmodel.PointNet2SemSeg(spec=jspec)
    tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), pc)
    variables = _draw(tree, 27)
    pm = pointnet2.PointNet2SemSeg(pspec)
    state = {k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(variables, pspec).items()}
    pm.train()
    apply = jax.jit(lambda v, x, m: jm.apply(v, x, train=True, bn_momentum=m, mutable=["batch_stats"]))

    def run(m, compare=True):
        pm.load_state_dict(state, strict=True)
        got = pm(torch.from_numpy(pc), bn_momentum=m)
        if compare:
            want, mutated = apply(variables, pc, jnp.float32(m))
            _close(got, want)
            moved = convert.state_dict_from_jax({"params": variables["params"], **mutated}, pspec)
            for k, v in _moved(pm).items():
                np.testing.assert_allclose(v.numpy(), moved[k], rtol=RTOL, atol=ATOL, err_msg=k)
        return _moved(pm)

    _momentum_runs(run)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(pspec)
