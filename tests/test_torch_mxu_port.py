"""The op-lowering switches and the kernels they select, against the JAX
package on the CPU.

- Routing: ops/tuning.gather_route and three_nn_route against the lowering
  the JAX package's gather_points, group_points and three_nn take, over a
  grid of shapes and switch settings, with the JAX side traced abstractly
  (jax.eval_shape) and its kernel entry points replaced by recorders. "auto"
  is tried both ways: off (the CPU) and on (the JAX package's _on_tpu()
  patched, the port's auto=True, as on the card).
- e, f and g: the port's mxu_gather and mxu_gather_split (on the CPU the
  plain versions of gather_smem.cu, scatter_smem.cu and scatter_add.cu)
  against the JAX Pallas kernels run in interpret mode: forwards bit for
  bit on finite values without -0.0 (the one-hot product turns -0.0 into
  +0.0), gradients within 1e-6 (the products add in another order).
- j: the port's three_nn at shapes routed to the query-major kernel against
  three_nn_pallas(interpret=True): indices equal, d^2 within 2 ulp (the
  jitted kernel contracts into fma on the CPU).
- The slice: a small SSG model under the MXU-gather configuration (P1:
  logits, one train step's loss and gradients; a small MSG model's logits
  under the same switches) and with a query count at
  FP0 that is not a multiple of 128 (P2: logits), the same switches on both
  sides, weights moved by models/convert.py; both sides must take the
  routed kernels.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.engine import loss as jloss
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.ops import interpolate as jinterp
from pointnet2_scannet_tpu.ops import neighborhood as jnb
from pointnet2_scannet_tpu.ops import sampling as jsamp
from pointnet2_scannet_tpu.ops import tuning as jtuning
from pointnet2_scannet_tpu.ops.pallas import gather_kernel as jgk
from pointnet2_scannet_tpu.ops.pallas import three_nn_kernel as jnn
from pointnet2_scannet_tpu.ops.pallas import vmem_gather_kernel as jvk
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from pointnet2_scannet_tpu_torch.ops import mxu_gather as pmg
from pointnet2_scannet_tpu_torch.ops import tuning
from tests.test_torch_msg_port import SMALL_MSG
from tests.test_torch_port_model import SMALL, _randomize_bn

SETTINGS = {
    "default": {},
    "vmem_off": {"vmem_gather": False},
    "vmem_off_mxu_on": {"vmem_gather": False, "mxu_gather": True},
}


def _switch(monkeypatch, **fields):
    """The same ops_config fields on both sides, restored after the test."""
    for k, v in fields.items():
        monkeypatch.setattr(jtuning.ops_config, k, v)
        monkeypatch.setattr(tuning.ops_config, k, v)


def _interpret(monkeypatch):
    """Every pl.pallas_call in interpret mode (overriding an explicit
    interpret=False, as three_nn_pallas passes)."""
    orig = jgk.pl.pallas_call
    monkeypatch.setattr(jgk.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


# ------------------------------------------------------------------ routing


@pytest.fixture
def recorders(monkeypatch):
    """Replace the JAX kernel entry points with recorders of the route taken."""
    taken = []

    def record(route, fn):
        def wrapper(*args, **kwargs):
            taken.append(route)
            return fn(*args, **kwargs)
        return wrapper

    def gather_stub(src, idx, **_):
        return jnp.zeros(idx.shape + src.shape[-1:], src.dtype)

    def three_nn_stub(unknown, known, **_):
        shape = unknown.shape[:2] + (3,)
        return jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.int32)

    monkeypatch.setattr(jvk, "vmem_gather_any", record("vmem", gather_stub))
    monkeypatch.setattr(jgk, "mxu_gather", record("mxu", gather_stub))
    monkeypatch.setattr(jnn, "three_nn_pallas_t", record("t", three_nn_stub))
    monkeypatch.setattr(jnn, "three_nn_pallas", record("q", three_nn_stub))
    return taken


def _on_tpu(monkeypatch, auto):
    for mod in (jsamp, jnb):
        monkeypatch.setattr(mod, "_on_tpu", lambda: auto)
    monkeypatch.setattr(jinterp, "on_tpu_backend", lambda: auto)


def _jax_route(taken, fn, *shapes):
    taken.clear()
    jax.eval_shape(lambda *a: fn(*a), *shapes)  # a new function: no cached trace
    assert len(taken) <= 1
    return taken[0] if taken else "xla"


GATHER_N = (64, 100, 256, 1024, 8192, 12288, 16384)
GATHER_J = (64, 128, 2048, 32768)
GATHER_C = (3, 9, 67, 131, 259)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("auto", [False, True], ids=["auto_off", "auto_on"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_gather_route_matches_jax(monkeypatch, recorders, setting, auto):
    _switch(monkeypatch, **SETTINGS[setting])
    _on_tpu(monkeypatch, auto)
    seen = set()
    for n in GATHER_N:
        for j in GATHER_J:
            for c in GATHER_C:
                for jdt, tdt in DTYPES.values():
                    src = jax.ShapeDtypeStruct((1, n, c), jdt)
                    idx = jax.ShapeDtypeStruct((1, j), jnp.int32)
                    want = _jax_route(recorders, jsamp.gather_points, src, idx)
                    got = tuning.gather_route(n, j, c, tdt, auto=auto)
                    assert got == want, (n, j, c, tdt)
                    seen.add(got)
                    if j == 2048 and c == 9:  # group_points: J = M * K
                        grouped = jax.ShapeDtypeStruct((1, 64, 32), jnp.int32)
                        assert _jax_route(recorders, jnb.group_points, src, grouped) == want
    # every route the setting can take was taken somewhere on the grid
    expected = {("default", False): {"xla"}, ("default", True): {"vmem", "xla"},
                ("vmem_off", False): {"xla"}, ("vmem_off", True): {"xla"},
                ("vmem_off_mxu_on", False): {"mxu", "xla"}, ("vmem_off_mxu_on", True): {"mxu", "xla"}}
    assert seen == expected[(setting, auto)]


@pytest.mark.parametrize("use_mxu", [True, False])
def test_gather_route_explicit_use_mxu_matches_jax(monkeypatch, recorders, use_mxu):
    _on_tpu(monkeypatch, True)
    for n, j, c in [(1024, 2048, 9), (1024, 64, 9), (16384, 2048, 9), (100, 2048, 9)]:
        src = jax.ShapeDtypeStruct((1, n, c), jnp.float32)
        idx = jax.ShapeDtypeStruct((1, j), jnp.int32)
        want = _jax_route(recorders, lambda s, i: jsamp.gather_points(s, i, use_mxu=use_mxu), src, idx)
        assert tuning.gather_route(n, j, c, torch.float32, use_mxu) == want


def test_mxu_gates_match_jax():
    for n in GATHER_N + (128, 2048, 4096):
        for j in GATHER_J + (16384, 16512):
            for c in GATHER_C + (32, 384, 385):
                src = jax.ShapeDtypeStruct((1, n, c), jnp.float32)
                assert pmg.supported(n, j, c) == jgk.supported(src, j), (n, j, c)
                assert pmg.scatter_supported(n, j, c) == jgk.scatter_supported(n, j, c), (n, j, c)


THREE_NN_N = (64, 100, 128, 200, 256, 384, 640, 768, 1000, 1024, 7936, 8000, 8192)
THREE_NN_M = (3, 16, 64, 100, 128, 256, 1000, 1024, 4096, 4224, 8192)


@pytest.mark.parametrize("setting", ["auto_off", "auto_on", "forced_on", "forced_off"])
def test_three_nn_route_matches_jax(monkeypatch, recorders, setting):
    _on_tpu(monkeypatch, setting == "auto_on")
    forced = {"forced_on": True, "forced_off": False}.get(setting)
    _switch(monkeypatch, three_nn_pallas=forced)
    seen = set()
    for n in THREE_NN_N:
        for m in THREE_NN_M:
            unknown = jax.ShapeDtypeStruct((1, n, 3), jnp.float32)
            known = jax.ShapeDtypeStruct((1, m, 3), jnp.float32)
            want = _jax_route(recorders, jinterp.three_nn, unknown, known)
            got = tuning.three_nn_route(n, m, auto=setting == "auto_on")
            assert got == want, (n, m)
            seen.add(got)
    assert seen == ({"t", "q", "xla"} if setting in ("auto_on", "forced_on") else {"xla"})


def test_three_nn_routes_of_the_ssg_levels():
    # FP0 to FP3 at 8192-, 8000- and 7936-point columns (SA npoints 1024,
    # 256, 64, 16): the query-major kernel runs at FP0 only when the
    # known-major one's 512-query tile does not divide n and n % 256 == 0
    levels = lambda n: [(n, 1024), (1024, 256), (256, 64), (64, 16)]  # noqa: E731
    assert [tuning.three_nn_route(n, m) for n, m in levels(8192)] == ["t", "t", "t", "xla"]
    assert [tuning.three_nn_route(n, m) for n, m in levels(8000)] == ["xla", "t", "t", "xla"]
    assert [tuning.three_nn_route(n, m) for n, m in levels(7936)] == ["q", "t", "t", "xla"]
    assert tuning.three_nn_route(8192, 8192) == "q"


# ------------------------------------------------------- kernels e, f, g, j


MXU_SHAPES = [((2, 256, 8), 384), ((2, 1024, 67), 8192), ((2, 256, 131), 2048)]


def _gather_grads(fn, src, idx, g):
    x = torch.from_numpy(src).requires_grad_(True)
    out = fn(x, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("shape,j", MXU_SHAPES, ids=lambda v: str(v))
def test_mxu_gather_matches_jax_interpret(monkeypatch, shape, j):
    _interpret(monkeypatch)
    rng = np.random.default_rng(shape[1] + j)
    src = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, shape[1], (shape[0], j)).astype(np.int32)
    g = rng.normal(size=(shape[0], j, shape[2])).astype(np.float32)
    got, got_grad = _gather_grads(pmg.mxu_gather, src, idx, g)
    want, vjp = jax.vjp(lambda s: jgk.mxu_gather(s, jnp.asarray(idx)), jnp.asarray(src))
    np.testing.assert_array_equal(got, np.asarray(want))
    (want_grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=1e-6, atol=1e-6)


def test_mxu_gather_split_matches_jax_interpret(monkeypatch):
    _interpret(monkeypatch)
    rng = np.random.default_rng(31)
    # the adversarial finite values of test_split3_bf16_is_exact, without -0.0
    values = np.concatenate([
        rng.normal(size=1024), rng.uniform(-1e30, 1e30, 64), rng.uniform(-1e-30, 1e-30, 64),
        [0.0, 1.0, -1.0, np.pi, 2**-120],
    ]).astype(np.float32)
    src = rng.permutation(np.resize(values, 2 * 256 * 9)).reshape(2, 256, 9)
    idx = rng.integers(0, 256, (2, 1024)).astype(np.int32)
    g = rng.normal(size=(2, 1024, 9)).astype(np.float32)
    got, got_grad = _gather_grads(pmg.mxu_gather_split, src, idx, g)
    want, vjp = jax.vjp(lambda s: jgk.mxu_gather_split(s, jnp.asarray(idx)), jnp.asarray(src))
    # the port returns every word; JAX's split returns every word whose
    # third bf16 plane lies in bf16's normal range (|x| >= 2^-100 here):
    # below it the CPU's bf16 product flushes that plane, and a value such
    # as -2.7217677e-33 comes back as -2.7217631e-33
    exact = np.take_along_axis(src, idx[..., None].astype(np.int64), axis=1)
    np.testing.assert_array_equal(got.view(np.int32), exact.view(np.int32))
    normal = np.abs(exact) >= 2.0**-100
    assert normal.mean() > 0.95
    np.testing.assert_array_equal(got.view(np.int32)[normal], np.asarray(want).view(np.int32)[normal])
    (want_grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        pmg.mxu_scatter_add(torch.from_numpy(idx), torch.from_numpy(g), 256).numpy(), got_grad)


def _ulp_close(got, want, ulps):
    assert (np.abs(got - want) <= ulps * np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("n,m,ties", [(200, 128, False), (768, 1024, False), (200, 128, True),
                                      (256, 4224, False)])
def test_three_nn_query_major_matches_jax_interpret(monkeypatch, n, m, ties):
    _switch(monkeypatch, three_nn_pallas=True)
    rng = np.random.default_rng(n + m)
    unknown = rng.uniform(0, 1.5, (2, n, 3)).astype(np.float32)
    known = rng.uniform(0, 1.5, (2, m, 3)).astype(np.float32)
    if ties:  # every known point twice, and queries on known points
        known[:, m // 2:] = known[:, : m - m // 2]
        unknown[:, :32] = known[:, :32]
    tuning.reset_route_counts()
    dist2, idx = ops.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert tuning.route_counts == {("three_nn", "q"): 1}
    want_d, want_i = jnn.three_nn_pallas(jnp.asarray(unknown), jnp.asarray(known), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    _ulp_close(dist2.numpy(), np.asarray(want_d), 2)
    # and exactly the eager JAX op's XLA path (no contraction there)
    want_d, want_i = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known), use_pallas=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(dist2.numpy(), np.asarray(want_d))


# -------------------------------------------------------------- the slice


# SA1 takes 128 of N points, SA2 32 of them: under the MXU-gather switches
# SA1's gathers (N = 512) and SA2's grouping (N = 128, J = 256) take the MXU
# route, SA2's with a gradient; at N = 200, FP0 (n = 200, m = 128) routes
# to the query-major 3-NN
SLICE = dict(SMALL, npoints=(128, 32), dropout=0.0)
SLICE_MSG = dict(SMALL_MSG, npoints=(128, 32), dropout=0.0)


def _models(n, seed, spec=SLICE):
    jspec, pspec = jmodel.PointNet2Spec(**spec), pointnet2.PointNet2Spec(**spec)
    rng = np.random.default_rng(seed)
    pc = np.concatenate([rng.uniform(0, 1.5, (2, n, 3)), rng.normal(0, 0.5, (2, n, 3))], -1)
    pc = pc.astype(np.float32)
    jm = jmodel.PointNet2SemSeg(spec=jspec)
    variables = _randomize_bn(jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(pc)), seed)
    pm = pointnet2.PointNet2SemSeg(pspec)
    state = convert.state_dict_from_jax(variables, pspec)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return jm, variables, pm, pc


def _flat_grads(grads):
    """JAX parameter gradients under the port's state_dict names, float64
    (models/convert.py's naming, without its float32 cast)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        *scope, name = (getattr(k, "key", None) for k in path)
        a = np.asarray(leaf, np.float64)
        out[".".join(scope) + (".bias" if name == "bias" else ".weight")] = a.T if name == "kernel" else a
    return out


@contextlib.contextmanager
def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    yield calls


def test_slice_p1_mxu_gather_config_matches_jax(monkeypatch):
    _switch(monkeypatch, vmem_gather=False, mxu_gather=True)
    _interpret(monkeypatch)
    jm, variables, pm, pc = _models(512, 41)
    tuning.reset_route_counts()
    with _counting(monkeypatch, jgk, "mxu_gather") as jax_calls:
        want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # SA1 centroids and grouping, SA2 grouping: MXU; SA2 centroids (J = 32)
    # and the interpolations: not
    assert len(jax_calls) == 3
    assert tuning.route_counts[("gather", "mxu")] == 3 and tuning.route_counts[("gather", "xla")] == 1


def test_slice_p1_msg_under_the_mxu_gather_config_matches_jax(monkeypatch):
    # the switches are process-wide: the MSG model's two-radius groupings and
    # its pregather's narrow gathers route by the same conditions
    _switch(monkeypatch, vmem_gather=False, mxu_gather=True)
    _interpret(monkeypatch)
    jm, variables, pm, pc = _models(512, 45, SLICE_MSG)
    tuning.reset_route_counts()
    with _counting(monkeypatch, jgk, "mxu_gather") as jax_calls:
        want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # seven gathers take the MXU route on both sides; SA2's centroids (J = 32)
    # do not
    assert len(jax_calls) == 7
    assert tuning.route_counts[("gather", "mxu")] == 7 and tuning.route_counts[("gather", "xla")] == 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slice_p1_train_step_matches_jax(monkeypatch, dtype):
    # loss and gradients of one step against jax.value_and_grad of the JAX
    # train_step's loss, within tests/test_torch_train_step.py's bounds
    # (float64: loss rtol 1e-8, per-tensor relative L2 1e-7; float32: loss
    # rtol 1e-4, relative L2 worst 5e-2, median 1e-3)
    tol = {"float64": (1e-8, 1e-7, 1e-7), "float32": (1e-4, 5e-2, 1e-3)}[dtype]
    _switch(monkeypatch, vmem_gather=False, mxu_gather=True)
    _interpret(monkeypatch)
    jm, variables, pm, pc = _models(512, 42)
    rng = np.random.default_rng(43)
    labels = rng.integers(0, SLICE["num_classes"], (2, 512)).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, (2, 512)).astype(dtype)
    pm.to(getattr(torch, dtype))
    state = ts.create_train_state(pm, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=0)
    tuning.reset_route_counts()
    out = ts.train_step(state, {"points": torch.from_numpy(pc.astype(dtype)),
                                "labels": torch.from_numpy(labels),
                                "weights": torch.from_numpy(weights)}, num_classes=SLICE["num_classes"])
    got = {k: p.grad.double().numpy() for k, p in pm.named_parameters()}
    assert tuning.route_counts[("gather", "mxu")] == 3

    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), variables)

        def loss_fn(params):
            logits, _ = jm.apply({"params": params, "batch_stats": jvars["batch_stats"]},
                                 jnp.asarray(pc, dtype), train=True, mutable=["batch_stats"])
            return jloss.weighted_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(weights))

        with _counting(monkeypatch, jgk, "mxu_gather") as jax_calls:
            want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
        assert len(jax_calls) == 3
        want = _flat_grads(grads)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert float(out["loss"]) == pytest.approx(float(want_loss), rel=tol[0])
    assert set(want) == set(got)
    errors = sorted(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-300) for k, w in want.items())
    assert errors[-1] <= tol[1] and np.median(errors) <= tol[2], errors


def test_slice_p2_query_count_not_a_multiple_of_128_matches_jax(monkeypatch):
    _switch(monkeypatch, three_nn_pallas=True)
    _interpret(monkeypatch)
    jm, variables, pm, pc = _models(200, 44)
    tuning.reset_route_counts()
    with _counting(monkeypatch, jnn, "three_nn_pallas") as jax_q:
        want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # FP0 (n = 200, m = 128) takes the query-major kernel on both sides, FP1
    # (n = 128, m = 32) the known-major one
    assert len(jax_q) == 1
    assert tuning.route_counts[("three_nn", "q")] == 1 and tuning.route_counts[("three_nn", "t")] == 1
    assert dataclasses.asdict(tuning.ops_config)["three_nn_pallas"] is True


def test_bench_gather_torch_runs_the_plain_versions_on_the_cpu():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "bench_gather_torch.py"
    spec = importlib.util.spec_from_file_location("bench_gather_torch", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    (row,) = bench.run("cpu", reps=1, channels=(9,))
    assert (row["B"], row["N"], row["J"], row["device"]) == (2, 1024, 4096, "cpu")
    times = [v for k, v in row.items() if k.startswith(("fwd ", "bwd ")) and "err" not in k]
    assert len(times) == 8 and all(t > 0 for t in times)
    # on the CPU scatter_add_ adds in ascending j too
    assert row["bwd max_abs_err vs scatter_add_"] == 0.0


def test_profile_scatter_needs_a_card(monkeypatch):
    from pointnet2_scannet_tpu_torch.ops.cuda import profile_scatter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_scatter.main() == 1


@pytest.mark.parametrize("argv", [["d"], ["a"], ["d", "a", "--routes"], ["i"], ["b"]])
def test_profile_scatter_refuses_each_kernel_without_a_card(monkeypatch, argv):
    from pointnet2_scannet_tpu_torch.ops.cuda import profile_scatter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["profile_scatter", *argv])
    assert profile_scatter.main() == 1
