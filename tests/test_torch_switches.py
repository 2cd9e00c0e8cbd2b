"""The op-lowering switches of the port's ops/tuning.py against the JAX
package's, on the CPU.

Each test feeds the same numpy inputs to the JAX function and the port's,
with the same ops_config fields set on both sides (in try/finally):

- OpsConfig: the port's fields are the JAX package's eleven, in its order,
  with its defaults.
- three_interpolate_dense, _cached and _fast: values and the gradients of a
  numpy cotangent, in float32 and float64 within 1e-6 of the largest |value|
  (the dense products sum their three nonzero terms in either package's
  order), dense's weight gradient included, and none for idx or weight
  from cached and fast. In bfloat16 they measured bit-equal to the JAX
  functions at these shapes (5 seeds, and at 2 x 512 <- 64 x 16), and are
  held so.
- group_points_segsum: the forward exact; its backward bit for bit in
  float32 and float64 (both sum a source row's terms in ascending j). In
  bfloat16 the JAX segment sum adds in bfloat16 and the port sums in
  float32 and rounds once: the port's largest distance from a float64 sum
  is no larger than the JAX one's.
- FeaturePropagation under each interpolation switch and under
  group_segsum, and a small SSG model's float64 train step (loss and every
  parameter's gradient) under each interpolation switch, group_segsum with
  dense, weights moved by models/convert.py.
- fps_route and ball_query_route against the JAX conditions (the Pallas
  entry points replaced by recorders) over a grid of (N, M), auto on and
  off, forced on and off; route_counts shows the route each op took.
- pregather_dense True at a narrow input (the gate says no) and False at a
  wide one (the gate says yes), and False without features, against the
  JAX SetAbstraction.
- pairwise_sqdist(mode="dot") bit for bit, and the ball query and 3-NN with
  dist_mode="dot" equal to the JAX package's XLA paths.
- utils/profiling: StepTimer, trace on the CPU, device_memory_stats.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.models import modules as jmodules
from pointnet2_scannet_tpu.ops import common as jcommon
from pointnet2_scannet_tpu.ops import interpolate as jinterp
from pointnet2_scannet_tpu.ops import neighborhood as jnb
from pointnet2_scannet_tpu.ops import sampling as jsamp
from pointnet2_scannet_tpu.ops import tuning as jtuning
from pointnet2_scannet_tpu.ops.pallas import ball_query_kernel as jbq
from pointnet2_scannet_tpu.ops.pallas import fps_kernel as jfps
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.models import convert, modules
from pointnet2_scannet_tpu_torch.ops import common, interpolate, neighborhood, tuning
from pointnet2_scannet_tpu_torch.utils import profiling
from tests.test_torch_bf16_model import _jax_step_grads, _port_step_grads
from tests.test_torch_port_model import SMALL, _both

INTERP_TOL = 1e-6  # relative to the largest |value|
FORMS = ("dense", "cached", "fast")
SWITCHES = {"dense": {"interpolate_dense": True}, "cached": {"interpolate_cached": True},
            "fast": {"interpolate_fast": True}, "segsum": {"group_segsum": True}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _switched(**fields):
    """The same ops_config fields on both sides, restored after."""
    saved = [(cfg, k, getattr(cfg, k)) for cfg in (jtuning.ops_config, tuning.ops_config) for k in fields]
    try:
        for cfg, k, _ in saved:
            setattr(cfg, k, fields[k])
        yield
    finally:
        for cfg, k, v in saved:
            setattr(cfg, k, v)


@contextlib.contextmanager
def _x64(on: bool):
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_ops_config_has_every_jax_field_with_its_default():
    jfields = [(f.name, f.default) for f in dataclasses.fields(jtuning.OpsConfig)]
    pfields = [(f.name, f.default) for f in dataclasses.fields(tuning.OpsConfig)]
    assert pfields == jfields
    assert len(pfields) == 11
    assert dataclasses.asdict(tuning.ops_config) == dataclasses.asdict(jtuning.ops_config)


def _interp_inputs(seed, B=2, n=64, m=16, C=8):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, m, C))
    idx = np.stack([rng.permutation(m)[:3] for _ in range(B * n)]).reshape(B, n, 3).astype(np.int32)
    w = rng.uniform(0.1, 1, (B, n, 3))
    return pts, idx, w / w.sum(-1, keepdims=True), rng.normal(size=(B, n, C))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", FORMS)
def test_interpolation_forms_match_jax(form, dtype):
    pts, idx, w, g = (a if a.dtype == np.int32 else a.astype(dtype) for a in _interp_inputs(1))
    jfn, pfn = getattr(jinterp, f"three_interpolate_{form}"), getattr(interpolate, f"three_interpolate_{form}")
    with _x64(dtype == "float64"):
        out, vjp = jax.vjp(lambda p, ww: jfn(p, jnp.asarray(idx), ww), jnp.asarray(pts), jnp.asarray(w))
        jgp, jgw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
        assert out.dtype == jnp.dtype(dtype)
    tp, tw = (torch.from_numpy(a).requires_grad_(True) for a in (pts, w))
    o = pfn(tp, torch.from_numpy(idx), tw)
    assert o.dtype == getattr(torch, dtype)
    gp, gw = torch.autograd.grad(o, (tp, tw), torch.from_numpy(g), allow_unused=True)
    _close(o.detach().numpy(), out, INTERP_TOL)
    _close(gp.numpy(), jgp, INTERP_TOL)
    if form == "dense":
        _close(gw.numpy(), jgw, INTERP_TOL)
    else:  # no gradient to weight, as ThreeInterpolate.backward
        assert gw is None and not jgw.any()


@pytest.mark.parametrize("form", FORMS)
def test_interpolation_forms_match_jax_in_bfloat16(form):
    pts, idx, w, g = _interp_inputs(2, n=512, m=64, C=16)
    jfn, pfn = getattr(jinterp, f"three_interpolate_{form}"), getattr(interpolate, f"three_interpolate_{form}")
    jp = jnp.asarray(pts, jnp.float32).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda p: jfn(p, jnp.asarray(idx), jnp.asarray(w, jnp.float32)), jp)
    (jgp,) = vjp(jnp.asarray(g, jnp.float32).astype(out.dtype))
    tp = torch.from_numpy(pts.astype(np.float32)).to(torch.bfloat16).requires_grad_(True)
    o = pfn(tp, torch.from_numpy(idx), torch.from_numpy(w.astype(np.float32)))
    # W takes points' dtype in the dense forms; the gather form's weighted
    # sum promotes to float32
    assert str(o.dtype).split(".")[-1] == str(out.dtype)
    (gp,) = torch.autograd.grad(o, tp, torch.from_numpy(g.astype(np.float32)).to(o.dtype))
    assert gp.dtype == torch.bfloat16
    np.testing.assert_array_equal(o.detach().float().numpy(), np.asarray(out.astype(jnp.float32)))
    np.testing.assert_array_equal(gp.float().numpy(), np.asarray(jgp.astype(jnp.float32)))


def _segsum_inputs(seed, B=2, N=64, M=32, K=16, C=35):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, C)), rng.integers(0, N, (B, M, K)).astype(np.int32),
            rng.normal(size=(B, M, K, C)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_group_points_segsum_matches_jax_bit_for_bit(dtype):
    pts, idx, g = _segsum_inputs(3)
    pts, g = pts.astype(dtype), g.astype(dtype)
    with _x64(dtype == "float64"):
        out, vjp = jax.vjp(lambda p: jnb.group_points_segsum(p, jnp.asarray(idx)), jnp.asarray(pts))
        (jg,) = vjp(jnp.asarray(g))
        jg = np.asarray(jg)
    tp = torch.from_numpy(pts).requires_grad_(True)
    o = neighborhood.group_points_segsum(tp, torch.from_numpy(idx))
    (gp,) = torch.autograd.grad(o, tp, torch.from_numpy(g))
    np.testing.assert_array_equal(o.detach().numpy(), np.asarray(out))
    assert gp.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(gp.numpy(), jg)
    # and the default grouping's backward gives the same bits
    tp.grad = None
    (gd,) = torch.autograd.grad(ops.group_points(tp, torch.from_numpy(idx)), tp, torch.from_numpy(g))
    np.testing.assert_array_equal(gp.numpy(), gd.numpy())


def test_group_points_segsum_in_bfloat16_is_no_further_from_float64_than_jax():
    pts, idx, g = _segsum_inputs(4, M=64, K=32)
    gb = jnp.asarray(g, jnp.float32).astype(jnp.bfloat16)
    exact = np.zeros(pts.shape)
    np.add.at(exact, (np.arange(2)[:, None], idx.reshape(2, -1)),
              np.asarray(gb.astype(jnp.float32), np.float64).reshape(2, -1, pts.shape[-1]))
    jp = jnp.asarray(pts, jnp.float32).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda p: jnb.group_points_segsum(p, jnp.asarray(idx)), jp)
    (jg,) = vjp(gb)
    tp = torch.from_numpy(pts.astype(np.float32)).to(torch.bfloat16).requires_grad_(True)
    o = neighborhood.group_points_segsum(tp, torch.from_numpy(idx))
    (gp,) = torch.autograd.grad(o, tp, torch.from_numpy(np.asarray(gb.astype(jnp.float32))).to(torch.bfloat16))
    assert gp.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16
    port_err = np.abs(gp.double().numpy() - exact).max()
    jax_err = np.abs(np.asarray(jg.astype(jnp.float32), np.float64) - exact).max()
    assert port_err <= jax_err, (port_err, jax_err)
    # the port's is the float64 sum rounded once
    np.testing.assert_array_equal(gp.float().numpy(), torch.from_numpy(exact).to(torch.bfloat16).float().numpy())


def _fp_pair(seed, c_known=8, c_unknown=4, mlp=(8, 6)):
    rng = np.random.default_rng(seed)
    unk, kno = rng.uniform(0, 1.5, (2, 64, 3)), rng.uniform(0, 1.5, (2, 16, 3))
    args = [a.astype(np.float32) for a in (unk, kno, rng.normal(size=(2, 64, c_unknown)),
                                          rng.normal(size=(2, 16, c_known)))]
    jfp = jmodules.FeaturePropagation(mlp=mlp)
    variables = jax.jit(lambda k, *a: jfp.init(k, *a))(jax.random.PRNGKey(seed), *map(jnp.asarray, args))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pfp = modules.FeaturePropagation(mlp, c_known + c_unknown)
    state = convert.module_state_dict_from_jax(variables)
    pfp.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return jfp, variables, pfp, args


@pytest.fixture(scope="module")
def fp_pair():
    return _fp_pair(5)


@pytest.mark.parametrize("switch", ["default", *SWITCHES])
def test_feature_propagation_under_each_switch_matches_jax(fp_pair, switch):
    jfp, variables, pfp, args = fp_pair
    g = np.random.default_rng(6).normal(size=(2, 64, 6)).astype(np.float32)
    with _switched(**SWITCHES.get(switch, {})):
        def loss(params, kf):
            out, _ = jfp.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               *map(jnp.asarray, args[:3]), kf, train=True, mutable=["batch_stats"])
            return jnp.sum(out * g), out

        # a new function a switch: traced under it, not from a cached trace
        (_, jout), (jgp, jgk) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(args[3]))
        tuning.reset_route_counts()
        pfp.zero_grad()
        kf = torch.from_numpy(args[3]).requires_grad_(True)
        pfp.train()
        out = pfp(*map(torch.from_numpy, args[:3]), kf)
        (out * torch.from_numpy(g)).sum().backward()
        route = tuning.interpolate_route()
    assert tuning.route_counts[("interpolate", route)] == 1
    assert route == (switch if switch in FORMS else "gather")
    _close(out.detach().numpy(), jout, 1e-5)
    _close(kf.grad.numpy(), jgk, 1e-5)
    jflat = convert.module_state_dict_from_jax({"params": jgp, "batch_stats": variables["batch_stats"]})
    for k, p in pfp.named_parameters():
        _close(p.grad.numpy(), jflat[k], 1e-5)


@pytest.fixture(scope="module")
def ssg_pair():
    jm, variables, pm, pc = _both(dict(SMALL, dropout=0.0), batch=2, n=256, seed=8)
    return jm, variables, pm.double(), pc


# group_segsum reads no interpolation switch: it rides with dense, which
# saves the JAX step a compile
SSG_SWITCHES = {"dense_segsum": {"interpolate_dense": True, "group_segsum": True},
                "cached": SWITCHES["cached"], "fast": SWITCHES["fast"]}


@pytest.mark.parametrize("switch", list(SSG_SWITCHES))
def test_small_ssg_train_step_under_each_switch_matches_jax_in_float64(ssg_pair, switch):
    # loss rtol 1e-8 and per-tensor relative L2 1e-7, the float64 bounds of
    # tests/test_torch_train_step.py
    jm, variables, pm, pc = ssg_pair
    rng = np.random.default_rng(9)
    labels = rng.integers(0, SMALL["num_classes"], (2, 256)).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, (2, 256))
    pm.zero_grad()
    with _switched(**SSG_SWITCHES[switch]), _x64(True):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        j_loss, j_grads = _jax_step_grads(jm, jvars, pc.astype(np.float64), labels, weights)
        tuning.reset_route_counts()
        p_loss, p_grads = _port_step_grads(pm, pc.astype(np.float64), labels, weights, torch.float64)
    want = {k: np.asarray(v, np.float64) for k, v in _flat(j_grads).items()}
    assert p_loss == pytest.approx(j_loss, rel=1e-8)
    assert set(want) == set(p_grads)
    errors = [np.linalg.norm(p_grads[k] - w) / max(np.linalg.norm(w), 1e-300) for k, w in want.items()]
    assert max(errors) <= 1e-7, errors
    assert tuning.route_counts[("interpolate", switch.split("_")[0])] == 2  # FP0, FP1
    # SA1's and SA2's groupings
    assert tuning.route_counts[("group", "segsum" if "segsum" in switch else "gather")] == 2


def _flat(grads):
    """JAX parameter gradients under the port's state_dict names."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        *scope, name = (getattr(k, "key", None) for k in path)
        a = np.asarray(leaf, np.float64)
        out[".".join(scope) + (".bias" if name == "bias" else ".weight")] = a.T if name == "kernel" else a
    return out


@pytest.fixture
def recorders(monkeypatch):
    """The JAX Pallas entry points of FPS and the ball query replaced by
    recorders of the route taken."""
    taken = []

    def fps_stub(xyz, npoint, **_):
        taken.append("pallas")
        return jnp.zeros(xyz.shape[:1] + (npoint,), jnp.int32)

    def bq_stub(radius, nsample, xyz, new_xyz, **_):
        taken.append("pallas")
        return jnp.zeros(new_xyz.shape[:2] + (nsample,), jnp.int32)

    monkeypatch.setattr(jfps, "furthest_point_sample_pallas", fps_stub)
    monkeypatch.setattr(jbq, "ball_query_pallas", bq_stub)
    return taken


def _jax_route(taken, fn, *shapes):
    taken.clear()
    jax.eval_shape(lambda *a: fn(*a), *shapes)
    return taken[0] if taken else "xla"


# every condition of either route: N % 128 (100), M <= 128 or M % 128 (200),
# the query tile's envelope (an odd M at 131072 points cannot halve into it)
ROUTE_N = (100, 256, 8192, 32768, 131072)
ROUTE_M = (16, 75, 128, 200, 1024)


@pytest.mark.parametrize("setting", [None, True, False], ids=["auto", "forced_on", "forced_off"])
@pytest.mark.parametrize("auto", [False, True], ids=["cpu", "tpu"])
def test_fps_and_ball_query_routes_match_jax(monkeypatch, recorders, setting, auto):
    for mod in (jsamp, jnb):
        monkeypatch.setattr(mod, "_on_tpu", lambda: auto)
    fps = jsamp.furthest_point_sample.__wrapped__  # the jitted one would reuse a cached trace
    seen = set()
    with _switched(fps_pallas=setting, ball_query_pallas=setting):
        for n in ROUTE_N:
            xyz = jax.ShapeDtypeStruct((1, n, 3), jnp.float32)
            want = _jax_route(recorders, lambda x: fps(x, 16), xyz)
            assert tuning.fps_route(n, auto=auto) == want, n
            seen.add(("fps", want))
            for m in ROUTE_M:
                q = jax.ShapeDtypeStruct((1, m, 3), jnp.float32)
                want = _jax_route(recorders, lambda x, y: jnb.ball_query(0.2, 8, x, y), xyz, q)
                assert tuning.ball_query_route(n, m, auto=auto) == want, (n, m)
                seen.add(("ball_query", want))
    on = setting if setting is not None else auto
    assert seen == ({("fps", r) for r in ("pallas", "xla")} | {("ball_query", r) for r in ("pallas", "xla")}
                    if on else {("fps", "xla"), ("ball_query", "xla")})
    # the ops count the route their call took (on the CPU: auto off)
    xyz = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 256, 3)).astype(np.float32))
    with _switched(fps_pallas=setting, ball_query_pallas=setting):
        tuning.reset_route_counts()
        idx = ops.furthest_point_sample(xyz, 100)
        ops.ball_query(0.3, 8, xyz, ops.gather_points(xyz, idx))
        route = "pallas" if setting else "xla"  # (256, 100): aligned enough for both kernels
        assert tuning.route_counts[("fps", route)] == 1 and tuning.route_counts[("ball_query", route)] == 1


def _sa_pair(c, widths, seed, dtype=None):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, c)).astype(np.float32)
    kw = dict(npoint=64, radii=[0.3], nsamples=[8], mlps=[widths])
    jsa = jmodules.SetAbstraction(**kw)
    variables = jax.jit(lambda k, x, f: jsa.init(k, x, f))(jax.random.PRNGKey(seed), jnp.asarray(xyz),
                                                          jnp.asarray(feats))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    psa = modules.SetAbstraction(64, [0.3], [8], [widths], c)
    state = convert.module_state_dict_from_jax(variables)
    psa.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return jsa, variables, psa, xyz, feats


@pytest.mark.parametrize("c,widths,forced", [(3, (16, 16), True), (40, (8, 16), False)],
                         ids=["narrow_forced_on", "wide_forced_off"])
def test_pregather_dense_forces_the_composition_as_jax(c, widths, forced):
    jsa, variables, psa, xyz, feats = _sa_pair(c, widths, 11)
    psa.eval()
    auto = psa._pregather(torch.from_numpy(feats), widths)
    assert auto == (not forced)  # the gate alone would choose the other
    with _switched(pregather_dense=forced):
        assert jsa._pregather(jnp.asarray(feats), widths, False) == forced
        _, want, _ = jax.jit(lambda v, x, f: jsa.apply(v, x, f, train=False))(
            variables, jnp.asarray(xyz), jnp.asarray(feats))
        tuning.reset_route_counts()
        with torch.inference_mode():
            _, got = psa(torch.from_numpy(xyz), torch.from_numpy(feats))
        assert tuning.route_counts[("pregather", 64)] == int(forced)
        # and never without features
        assert not psa._pregather(None, widths) and not jsa._pregather(None, widths, False)
    _close(got.numpy(), want, 1e-5)


def test_pairwise_sqdist_dot_is_jax_bit_for_bit():
    rng = np.random.default_rng(12)
    for dtype in ("float32", "float64"):
        a, b = rng.uniform(0, 1.5, (2, 300, 3)).astype(dtype), rng.uniform(0, 1.5, (2, 77, 3)).astype(dtype)
        with _x64(dtype == "float64"):
            want = np.asarray(jcommon.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b), mode="dot"))
        got = common.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b), mode="dot").numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown mode"):
        common.pairwise_sqdist(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), mode="l1")


def test_dist_mode_dot_ball_query_and_three_nn_match_jax():
    rng = np.random.default_rng(13)
    xyz = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    q = xyz[:, :64].copy()
    want = np.asarray(jnb.ball_query(0.2, 16, jnp.asarray(xyz), jnp.asarray(q), dist_mode="dot"))
    got = ops.ball_query(0.2, 16, torch.from_numpy(xyz), torch.from_numpy(q), dist_mode="dot").numpy()
    np.testing.assert_array_equal(got, want)
    jd, ji = jinterp.three_nn(jnp.asarray(xyz), jnp.asarray(q), dist_mode="dot")
    d, i = ops.three_nn(torch.from_numpy(xyz), torch.from_numpy(q), dist_mode="dot")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    grouped = neighborhood.query_and_group(0.2, 16, torch.from_numpy(xyz), torch.from_numpy(q), None,
                                           dist_mode="dot")
    jgrouped = jnb.query_and_group(0.2, 16, jnp.asarray(xyz), jnp.asarray(q), None, dist_mode="dot")
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(jgrouped))


def test_step_timer_trace_and_memory_stats(tmp_path):
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.measure("step"):
            pass
    with timer.measure("fetch"):
        pass
    assert timer.counts == {"step": 3, "fetch": 1}
    assert set(timer.summary()) == {"step", "fetch"}
    assert timer.mean("step") == pytest.approx(timer.totals["step"] / 3)
    assert timer.mean("never") == 0.0
    timer.reset()
    assert timer.summary() == {}
    with profiling.trace(tmp_path, cuda=False):
        torch.ones(4).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))
    assert profiling.device_memory_stats() == []
