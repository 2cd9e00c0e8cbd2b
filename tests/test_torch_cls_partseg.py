"""The port's shape families against the JAX package's on the CPU.

- FC (Linear + BatchNorm on (B, C) vectors, optional pre-activation)
  against the JAX FC in train and eval mode: outputs and moved BatchNorm
  statistics within 1e-5 in float32.
- PointNet2Cls and PointNet2PartSeg, SSG and MSG, at the published widths
  (cls: 8 classes; partseg: 8 categories, 17 parts) on B 2 x N 512 clouds of
  data/shapes.py: variables drawn with numpy on the JAX tree (randomised
  BatchNorm statistics, so a swapped mapping cannot pass), moved into the
  port by models/convert.state_dict_from_jax with a strict load; eval
  logits within rtol = atol = 1e-4 (float32 matmul order; every index the
  ops produce is identical).
- One train step with Dropout off on both sides (dataclasses.replace(spec,
  dropout=0.0)): the port's engine train_step against the JAX model's
  value_and_grad of the JAX weighted_cross_entropy, with the batch
  statistics moved (flax's mutable batch_stats), held to
  tests/test_torch_train_step.py's bounds: the loss, the gradients and the
  moved BatchNorm statistics. cls SSG in float64 on both sides; partseg MSG
  (whose SA2 takes the pregather, c_in 323 >= 2 * widths[0], and the
  two-radius query's plain version) in float32 against the JAX float64
  step. Each test's docstring says why.
- scripts/jax_to_torch.py converts a JAX cls or partseg run dir.
"""

import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.engine import loss as jloss
from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.models import pointnet2_cls as jcls
from pointnet2_scannet_tpu.models import pointnet2_partseg as jps
from pointnet2_scannet_tpu_torch.data import shapes
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.models import convert, layers, pointnet2_cls, pointnet2_partseg
from pointnet2_scannet_tpu_torch.ops import tuning

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, CLASSES, CATEGORIES = 2, 512, 8, 8
PARTS = shapes.num_parts_total(CATEGORIES)
RTOL = ATOL = 1e-4  # f32 matmul summation order (XLA vs PyTorch CPU BLAS)
FC_TOL = 1e-5
# tests/test_torch_train_step.py's bounds (losses, per-tensor relative L2, elementwise atol)
STEP_TOL = dict(loss=1e-4, l2=5e-2, l2_median=1e-3)  # float32
# float64: tests/test_torch_train_step.py's relative L2 and, elementwise, its
# atol taken relative to each tensor's largest value (SA1's weight
# gradients reach 20, where float32 logits leave 6e-6)
F64_TOL = dict(l2=1e-7, atol=1e-6)
# a float64 step's loss: the mean CE of B = 2 rows of float32 logits, whose
# softmax runs in float32 in both packages (XLA's and PyTorch's exp differ by
# an ulp): two float32 ulps, not test_torch_train_step.py's 1e-8, which a
# mean over 512 points' CE reaches
F32_ULP_LOSS = 2.5e-7

SPECS = {
    ("cls", "ssg"): (jcls.cls_ssg_spec, pointnet2_cls.cls_ssg_spec),
    ("cls", "msg"): (jcls.cls_msg_spec, pointnet2_cls.cls_msg_spec),
    ("partseg", "ssg"): (jps.partseg_ssg_spec, pointnet2_partseg.partseg_ssg_spec),
    ("partseg", "msg"): (jps.partseg_msg_spec, pointnet2_partseg.partseg_msg_spec),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(kind: str, seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    if kind == "cls":
        return shapes.sample_cls_batch(rng, b, N, CLASSES)
    return shapes.sample_partseg_batch(rng, b, N, CATEGORIES)


def _draw(shapes_tree, seed: int):
    """Variables of the JAX tree's shapes, drawn with numpy: he-normal
    kernels, small biases, BatchNorm scale, bias, mean and var away from
    their identity values."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, np.sqrt(2.0 / s.shape[0]), s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(draw, shapes_tree)


def _jax_model(kind: str, spec):
    if kind == "cls":
        return jcls.PointNet2Cls(num_classes=CLASSES, spec=spec)
    return jps.PointNet2PartSeg(num_parts=PARTS, num_categories=CATEGORIES, spec=spec)


def _port_model(kind: str, spec):
    if kind == "cls":
        return pointnet2_cls.PointNet2Cls(CLASSES, spec)
    return pointnet2_partseg.PointNet2PartSeg(PARTS, CATEGORIES, spec)


def _pair(kind: str, variant: str, seed: int, dropout=None, b: int = B):
    """(JAX model, its numpy variables, the port model with them loaded,
    the batch)."""
    jspec_fn, pspec_fn = SPECS[kind, variant]
    jspec, pspec = jspec_fn(), pspec_fn()
    if dropout is not None:
        jspec, pspec = dataclasses.replace(jspec, dropout=dropout), dataclasses.replace(pspec, dropout=dropout)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(pspec)
    batch = _batch(kind, seed, b)
    jm = _jax_model(kind, jspec)
    tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                          jax.ShapeDtypeStruct(batch["points"].shape, jnp.float32))
    variables = _draw(tree, seed)
    pm = _port_model(kind, pspec)
    state = convert.state_dict_from_jax(variables, pspec)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return jm, variables, pm, batch


@pytest.mark.parametrize("bn,preact", [(True, False), (True, True), (False, False)],
                         ids=["bn", "preact", "no_bn"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fc_matches_the_jax_fc(bn, preact, train):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1.0, (16, 24)).astype(np.float32)
    jfc = jlayers.FC(out_size=12, bn=bn, preact=preact)
    tree = jax.eval_shape(lambda a: jfc.init(jax.random.PRNGKey(0), a), jax.ShapeDtypeStruct(x.shape, jnp.float32))
    variables = _draw(tree, 8)
    pfc = layers.FC(24, 12, bn=bn, preact=preact)
    sd = {}
    sd["fc.weight"] = torch.from_numpy(np.array(variables["params"]["fc"]["kernel"]).T.copy())
    if not bn:
        sd["fc.bias"] = torch.from_numpy(np.array(variables["params"]["fc"]["bias"]))
    else:
        name = "bn_pre" if preact else "bn"
        p, s = variables["params"][name], variables["batch_stats"][name]
        sd.update({f"{name}.weight": p["scale"], f"{name}.bias": p["bias"], f"{name}.running_mean": s["mean"],
                   f"{name}.running_var": s["var"], f"{name}.num_batches_tracked": np.array(0)})
        sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    pfc.load_state_dict(sd, strict=True)
    pfc.train(train)
    got = pfc(torch.from_numpy(x)).detach().numpy()
    if train and bn:
        want, mutated = jfc.apply(variables, x, train=True, mutable=["batch_stats"])
        name = "bn_pre" if preact else "bn"
        moved = mutated["batch_stats"][name]
        bn_mod = getattr(pfc, name)
        np.testing.assert_allclose(bn_mod.running_mean.numpy(), moved["mean"], rtol=FC_TOL, atol=FC_TOL)
        np.testing.assert_allclose(bn_mod.running_var.numpy(), moved["var"], rtol=FC_TOL, atol=FC_TOL)
    else:
        want = jfc.apply(variables, x, train=train)
    assert got.shape == (16, 12)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FC_TOL, atol=FC_TOL)


@pytest.mark.parametrize("kind,variant", list(SPECS), ids=[f"{k}-{v}" for k, v in SPECS])
def test_eval_logits_match_jax(kind, variant):
    jm, variables, pm, batch = _pair(kind, variant, seed=11)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, batch["points"]))
    with torch.inference_mode():
        got = pm(torch.from_numpy(batch["points"])).numpy()
    assert got.dtype == np.float32
    assert got.shape == ((B, CLASSES) if kind == "cls" else (B, N, PARTS))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_step(jm, variables, batch, dtype):
    """The JAX model's loss, gradients and moved BatchNorm statistics in
    dtype (float64 under x64), as the JAX train_step's loss_fn takes them."""

    def loss_fn(params, stats, points, labels, weights):
        logits, mutated = jm.apply({"params": params, "batch_stats": stats}, points, train=True,
                                   mutable=["batch_stats"])
        return jloss.weighted_cross_entropy(logits, labels, weights), mutated["batch_stats"]

    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), t)  # noqa: E731
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        cast(variables["params"]), cast(variables["batch_stats"]), jnp.asarray(batch["points"], dtype),
        batch["labels"], jnp.asarray(batch["weights"], dtype))
    return float(loss), jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {"params": grads,
                                                                                    "batch_stats": stats})


def _port_step(pm, batch, dtype, num_classes):
    """The port's engine train_step: (loss, gradients, moved BatchNorm
    statistics) as float64 numpy."""
    pm = pm.to(dtype)
    state = ts.create_train_state(pm, ts.make_lr_schedule(1e-3, 10, 0.7, 1), seed=0)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items() if k != "category"}
    tensors = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}
    out = ts.train_step(state, tensors, num_classes=num_classes)
    assert int(out["confusion"].sum()) == batch["labels"].size
    grads = {k: p.grad.double().numpy() for k, p in pm.named_parameters()}
    stats = {k: b.double().numpy() for k, b in pm.named_buffers() if "running" in k}
    return float(out["loss"]), grads, stats


def _rel_l2(got: dict, want: dict) -> list[float]:
    """Per-tensor relative L2 distances of got's tensors, sorted (worst last)."""
    return sorted(float(np.linalg.norm(v - want[k]) / np.linalg.norm(want[k])) for k, v in got.items())


def _all_l2(got: dict, want: dict) -> float:
    """Relative L2 distance over every tensor of got together."""
    return float(np.sqrt(sum(np.sum((v - want[k]) ** 2) for k, v in got.items()))
                 / np.sqrt(sum(np.sum(want[k] ** 2) for k in got)))


def test_train_step_cls_ssg_matches_jax_in_float64():
    """float64 on both sides (the float32 head's BatchNorm over B = 2 vectors
    amplifies rounding past any fixed float32 bound): the bounds of
    tests/test_torch_train_step.py's float64 case, over all parameters and
    at the median tensor (one BatchNorm bias has a zero gradient, a shift
    that the next train-mode BatchNorm removes), and elementwise. Both
    models cast their logits to float32, so the softmax runs in float32 in
    both."""
    jm, variables, pm, batch = _pair("cls", "ssg", seed=13, dropout=0.0)
    with _x64():
        j_loss, j_tree = _jax_step(jm, variables, batch, jnp.float64)
    want = convert.state_dict_from_jax(j_tree, pm.spec)
    loss, grads, stats = _port_step(pm, batch, torch.float64, CLASSES)
    np.testing.assert_allclose(loss, j_loss, rtol=F32_ULP_LOSS)
    assert set(grads) | set(stats) == {k for k in want if not k.endswith("num_batches_tracked")}
    for got in (grads, stats):
        assert _all_l2(got, want) <= F64_TOL["l2"] and np.median(_rel_l2(got, want)) <= F64_TOL["l2"]
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=F64_TOL["atol"] * max(np.abs(want[k]).max(), 1.0),
                                       err_msg=k)


def test_train_step_partseg_msg_matches_jax_in_float32():
    """The port's float32 step, whose SA2 scales take the pregather as the
    JAX model's float32 step does, against the JAX package's float64 step
    (which takes the unfused composition: the same function): the loss and
    the moved BatchNorm statistics at tests/test_torch_train_step.py's
    float32 bounds; the gradients within its median bound, 1e-3, over all
    parameters and at the median tensor (measured 3.2e-4 and 3.4e-4; the
    JAX package's own float32 step: 6.9e-3 and 6.6e-3). One cloud: its
    BatchNorm statistics run over its 512 points and their neighbourhoods."""
    jm, variables, pm, batch = _pair("partseg", "msg", seed=13, dropout=0.0, b=1)
    with _x64():
        ref_loss, ref_tree = _jax_step(jm, variables, batch, jnp.float64)
    ref = convert.state_dict_from_jax(ref_tree, pm.spec)
    tuning.reset_route_counts()
    loss, grads, stats = _port_step(pm, batch, torch.float32, PARTS)
    assert tuning.route_counts["pregather", 128] == 2  # SA2's two scales
    np.testing.assert_allclose(loss, ref_loss, rtol=STEP_TOL["loss"])
    errors = _rel_l2(stats, ref)
    assert errors[-1] <= STEP_TOL["l2"] and np.median(errors) <= STEP_TOL["l2_median"], errors
    assert _all_l2(grads, ref) <= STEP_TOL["l2_median"], _all_l2(grads, ref)
    assert np.median(_rel_l2(grads, ref)) <= STEP_TOL["l2_median"]


@pytest.mark.parametrize("kind,variant", [("cls", "msg"), ("partseg", "ssg")], ids=["cls-msg", "partseg-ssg"])
def test_jax_to_torch_converts_a_shape_run(tmp_path, kind, variant):
    """scripts/jax_to_torch.py on a run dir as the JAX shape trainers write
    it (their flat config.json, model_best.msgpack): the kind read from
    config.json, the port checkpoint equal to state_dict_from_jax, and the
    run dir served by engine/export.load_run_model."""
    import importlib.util
    import json

    import flax.serialization

    from pointnet2_scannet_tpu_torch.engine import checkpoint, export

    def script(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    args = vars(script(f"train_{kind}").parse_args(["--use_msg"] if variant == "msg" else []))
    args.update(epoch=20, num_devices=1, verbose=0)
    cfg = {**args, "shape_classes": list(shapes.SHAPE_CLASSES[:8])}
    if kind == "partseg":
        cfg["num_parts"] = PARTS
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    jm, variables, pm, _ = _pair(kind, variant, seed=17)
    (tmp_path / "model_best.msgpack").write_bytes(flax.serialization.msgpack_serialize(variables))
    script("jax_to_torch").main(["--folder", str(tmp_path)])
    got = checkpoint.load_state_dict(tmp_path, "model_best")
    want = convert.state_dict_from_jax(variables, pm.spec)
    assert set(got) == set(want) and all(torch.equal(got[k], torch.from_numpy(v)) for k, v in want.items())
    model, loaded = export.load_run_model(tmp_path)
    assert type(model) is type(pm) and loaded["use_msg"] == (variant == "msg")
    assert export.serving_shape(loaded) == ((1024, 3, CLASSES) if kind == "cls" else (1024, 3 + CATEGORIES, PARTS))
