"""The port's bfloat16 compute dtype against the JAX package's on the CPU.

Weights are JAX-initialised (BatchNorm statistics randomised) and moved by
models/convert.py; both packages run the same numpy inputs. bfloat16 keeps
8 bits of mantissa, and the two frameworks round at different places
(XLA's and PyTorch's CPU GEMMs sum in other orders and round their
products once; XLA may keep a fused chain's intermediates wider), so
outputs are held to bounds measured on these inputs, each stated beside
its measurement and no looser than it needs to be. Scale-relative errors
below are max |port - JAX| / max |JAX|.

- One PointwiseMLP (9 -> 32, 32, 64) in eval mode: 1 bfloat16 ulp at most
  (measured: one element in 65536 differs); in train mode 2 ulps of the
  output's largest magnitude (measured 0.0087 scale-relative, 0.7% of the
  elements), the running statistics within 5e-5 (measured 1.2e-5).
- MSG's SA3 (full width: 256 features, widths (128, 196, 256) twice) in
  bfloat16: the eval pregather composition on both sides, which is off in
  train mode on both; eval features within 1% scale-relative (measured
  0.51-0.67% over three draws).
- The SSG and MSG models (full width, 2 x 2048 points, the draws of the
  float32 tests) in eval mode: logits within 4% scale-relative (measured
  2.5% SSG, 2.0% MSG over five draws); labels agree on at least 99% of
  the points, a point counting as agreeing where either side's label is a
  maximum of the other's logits (bfloat16 ties; measured 0.996 and
  0.9998 on these draws, 0.988 on one other SSG draw of the five, whose
  random-weight logits put 1.4% of the points within one bfloat16 ulp of a
  tie); and equal wherever JAX's two largest logits differ by more than
  the logit bound (every draw).
- One bfloat16 train step of the small SSG and MSG specs, Dropout off
  (bounds measured over ten draws, seeds 2-6 of each): the loss within
  2e-3 relative (measured at most 1.1e-3). Both packages' bfloat16
  gradients lie 0.29-0.48 (relative L2 over all parameters) from a float64
  step of the same weights, because train-mode BatchNorm's backward
  cancels most of dy, so the port's are held to JAX's accuracy: over all
  parameters at most 1.5 times JAX's distance from the float64 step
  (measured ratio 0.94-1.22), the worst tensor at most twice JAX's worst
  (measured at most 1.17), and the port's median tensor no further from
  JAX's than JAX's are from the float64 step (measured at most 0.245
  against at least 0.29).
- Dtype flow: float32 interpolation and FP concatenation, bfloat16
  BatchNorm outputs and cls_out logits, float32 model output, in both.
- The loss on bfloat16 logits in the logits' dtype, within 1e-3 of JAX's.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import ops as jops
from pointnet2_scannet_tpu.engine import loss as jloss
from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.models import modules as jmodules
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.engine import loss as ploss
from pointnet2_scannet_tpu_torch.models import convert, layers, modules, pointnet2
from tests.test_torch_msg_port import SMALL_MSG
from tests.test_torch_port_model import SMALL, _load_mlp, _module_vars, _randomize_bn

BF16 = torch.bfloat16
MLP_TRAIN_STATS_ATOL = 5e-5
SA3_SCALE_TOL = 0.01
LOGIT_SCALE_TOL = 0.04
LABEL_AGREE = 0.99
STEP_LOSS_RTOL = 2e-3
GRAD_VS_JAX_ALL, GRAD_VS_JAX_WORST = 1.5, 2.0


def _ulp(x: np.ndarray) -> np.ndarray:
    """The bfloat16 spacing at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------------- MLP


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pointwise_mlp_bf16_matches_jax(train):
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 16, 9)).astype(np.float32)
    jm = jlayers.PointwiseMLP((32, 32, 64), dtype=jnp.bfloat16)
    v = _module_vars(jm, (jnp.asarray(x),), 0)
    pm = layers.PointwiseMLP(9, (32, 32, 64), dtype=BF16)
    _load_mlp(pm, v["params"], v["batch_stats"])
    pm.train(train)
    got = pm(torch.from_numpy(x))
    if train:
        want, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    if not train:
        assert np.all(np.abs(got - want) <= _ulp(want))
        return
    assert np.abs(got - want).max() <= 2 * _ulp(np.abs(want).max())
    for i in range(3):
        bn, stats = getattr(pm, f"bn_{i}"), mutated["batch_stats"][f"bn_{i}"]
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0,
                                   atol=MLP_TRAIN_STATS_ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=0,
                                   atol=MLP_TRAIN_STATS_ATOL)
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_msg_sa3_bf16_takes_the_eval_pregather_as_jax():
    spec = jmodel.msg_spec(20, 6)
    radii, nsamples, mlps = spec.radii[2], spec.nsamples[2], spec.sa_mlps[2]
    rng = np.random.default_rng(30)
    xyz = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (2, 256, 256)).astype(np.float32)
    jsa = jmodules.SetAbstraction(npoint=64, radii=radii, nsamples=nsamples, mlps=mlps, dtype=jnp.bfloat16)
    args = (jnp.asarray(xyz), jnp.asarray(feats).astype(jnp.bfloat16))
    v = _module_vars(jsa, args, 30)
    psa = modules.SetAbstraction(64, radii, nsamples, mlps, 256, dtype=BF16)
    for s in range(2):
        _load_mlp(getattr(psa, f"mlp_{s}"), v["params"][f"mlp_{s}"], v["batch_stats"][f"mlp_{s}"])
    pf = torch.from_numpy(feats).to(BF16)
    for train in (False, True):  # the gate: eval only in bfloat16, as in JAX
        psa.train(train)
        assert psa._pregather(pf, mlps[0]) == (not train) == jsa._pregather(args[1], mlps[0], train)
    assert psa._pregather(pf.float(), mlps[0])  # float32: in both modes
    psa.eval()
    calls = []
    orig = layers.PointwiseMLP.pregather
    layers.PointwiseMLP.pregather = lambda self, *a: calls.append(1) or orig(self, *a)
    try:
        with torch.inference_mode():
            got_xyz, got = psa(torch.from_numpy(xyz), pf)
    finally:
        layers.PointwiseMLP.pregather = orig
    want_xyz, want, _ = jax.jit(lambda v, *a: jsa.apply(v, *a, train=False))(v, *args)
    assert len(calls) == 2 and got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert _scale_err(got.float(), want) <= SA3_SCALE_TOL


# ----------------------------------------------------------------- models


def _models(spec_kwargs, batch, n, seed):
    jspec, pspec = jmodel.PointNet2Spec(**spec_kwargs), pointnet2.PointNet2Spec(**spec_kwargs)
    rng = np.random.default_rng(seed)
    pc = np.concatenate(
        [rng.uniform(0, 1.5, (batch, n, 3)), rng.normal(0, 0.5, (batch, n, jspec.input_channels))], -1
    ).astype(np.float32)
    jm = jmodel.PointNet2SemSeg(spec=jspec, dtype=jnp.bfloat16)
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = _randomize_bn(init(jax.random.PRNGKey(seed), jnp.asarray(pc)), seed)
    pm = pointnet2.PointNet2SemSeg(pspec, dtype=BF16)
    state = convert.state_dict_from_jax(variables, pspec)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return jm, variables, pm, pc


@pytest.mark.parametrize("kind,seed", [("ssg", 4), ("msg", 8)])
def test_model_bf16_logits_and_labels_match_jax(kind, seed):
    kwargs = dataclasses.asdict(getattr(jmodel, f"{kind}_spec")(20, 6))
    jm, variables, pm, pc = _models(kwargs, 2, 2048, seed)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    assert got.shape == (2, 2048, 20) and got.dtype == want.dtype == np.float32
    bound = LOGIT_SCALE_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    gl, wl = got.argmax(-1), want.argmax(-1)
    tie = (np.take_along_axis(want, gl[..., None], -1)[..., 0] == want.max(-1)) | \
          (np.take_along_axis(got, wl[..., None], -1)[..., 0] == got.max(-1))
    assert np.mean((gl == wl) | tie) >= LABEL_AGREE
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert np.array_equal(gl[clear], wl[clear])


def _jax_step_grads(jm, variables, pc, labels, weights):
    def loss_fn(params):
        logits, mutated = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(pc), train=True, mutable=["batch_stats"])
        return jloss.weighted_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(weights)), mutated

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), grads


def _port_step_grads(model, pc, labels, weights, dtype=torch.float32):
    model.train()
    logits = model(torch.from_numpy(pc).to(dtype))  # Dropout off: no generator needed
    loss = ploss.weighted_cross_entropy(logits, torch.from_numpy(labels).long(),
                                        torch.from_numpy(weights).to(dtype))
    loss.backward()
    return float(loss), {k: p.grad.double().numpy() for k, p in model.named_parameters()}


def _rel_l2(got: dict, want: dict) -> np.ndarray:
    """Per-tensor relative L2 distances."""
    return np.array([np.linalg.norm(got[k] - w) / np.linalg.norm(w) for k, w in want.items()])


def _rel_l2_all(got: dict, want: dict) -> float:
    """Relative L2 distance over all the tensors at once."""
    return float(np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
                         / sum(np.sum(w ** 2) for w in want.values())))


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_bf16_train_step_matches_jax(kind):
    kwargs = dict(SMALL if kind == "ssg" else SMALL_MSG, dropout=0.0)
    jm, variables, pm, pc = _models(kwargs, 2, 256, 2)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, kwargs["num_classes"], (2, 256)).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, (2, 256)).astype(np.float32)
    pspec = pointnet2.PointNet2Spec(**kwargs)

    j_loss, j_grads = _jax_step_grads(jm, variables, pc, labels, weights)
    j_grads = {k: np.asarray(v, np.float64) for k, v in convert.state_dict_from_jax(
        {"params": j_grads, "batch_stats": variables["batch_stats"]}, pspec).items()
        if not k.split(".")[-1].startswith(("running", "num_batches"))}
    p_loss, p_grads = _port_step_grads(pm, pc, labels, weights)
    ref = pointnet2.PointNet2SemSeg(pspec)
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(variables, pspec).items()})
    _, r_grads = _port_step_grads(ref.to(torch.float64), pc, labels, weights, torch.float64)

    assert set(p_grads) == set(j_grads) == set(r_grads)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert abs(p_loss - j_loss) <= STEP_LOSS_RTOL * abs(j_loss)
    jax_all = _rel_l2_all(j_grads, r_grads)
    assert _rel_l2_all(p_grads, r_grads) <= GRAD_VS_JAX_ALL * jax_all
    assert _rel_l2(p_grads, r_grads).max() <= GRAD_VS_JAX_WORST * _rel_l2(j_grads, r_grads).max()
    assert np.median(_rel_l2(p_grads, j_grads)) <= jax_all


# ------------------------------------------------------------- dtype flow


def test_bf16_dtype_flow_matches_jax(monkeypatch):
    jm, variables, pm, pc = _models(SMALL, 2, 256, 3)
    seen = {"jax": {}, "port": {}}

    def record(side, key):
        def wrap(fn):
            def inner(*a, **k):
                out = fn(*a, **k)
                seen[side][key] = str(out.dtype).replace("torch.", "")
                return out
            return inner
        return wrap

    monkeypatch.setattr(jops, "three_interpolate", record("jax", "interpolated")(jops.three_interpolate))
    monkeypatch.setattr(ops, "three_interpolate", record("port", "interpolated")(ops.three_interpolate))

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and mod.name == "mlp" and mod.parent.name == "fp_0":
            seen["jax"]["fp_concat"] = str(args[0].dtype)
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and mod.name in ("bn_0", "cls_out") and (
                mod.name == "cls_out" or mod.parent.name == "mlp" and mod.parent.parent.name == "fp_0"):
            seen["jax"]["fp_0 bn" if mod.name == "bn_0" else "cls_out"] = str(out.dtype)
        return out

    with nn.intercept_methods(interceptor):
        out = jm.apply(variables, jnp.asarray(pc), train=False)
    seen["jax"]["output"] = str(out.dtype)

    hooks = [
        pm.fp_0.mlp.register_forward_pre_hook(
            lambda m, a: seen["port"].__setitem__("fp_concat", str(a[0].dtype).replace("torch.", ""))),
        pm.cls_out.register_forward_hook(
            lambda m, a, o: seen["port"].__setitem__("cls_out", str(o.dtype).replace("torch.", ""))),
    ]
    orig = layers._batch_norm

    def bn(x, module, train, dtype=None, group=None, bn_momentum=None):
        y = orig(x, module, train, dtype, group, bn_momentum)
        if module is pm.fp_0.mlp.bn_0:
            seen["port"]["fp_0 bn"] = str(y.dtype).replace("torch.", "")
        return y

    monkeypatch.setattr(layers, "_batch_norm", bn)
    with torch.inference_mode():
        seen["port"]["output"] = str(pm(torch.from_numpy(pc)).dtype).replace("torch.", "")
    for h in hooks:
        h.remove()
    assert seen["port"] == seen["jax"] == {
        "interpolated": "float32", "fp_concat": "float32", "fp_0 bn": "bfloat16", "cls_out": "bfloat16",
        "output": "float32"}


def test_loss_on_bf16_logits_matches_jax():
    rng = np.random.default_rng(12)
    logits = rng.normal(0, 3, (2, 512, 20)).astype(np.float32)
    labels = rng.integers(0, 20, (2, 512)).astype(np.int32)
    weights = rng.uniform(0.5, 2, (2, 512)).astype(np.float32)
    got = ploss.weighted_cross_entropy(torch.from_numpy(logits).to(BF16), torch.from_numpy(labels).long(),
                                       torch.from_numpy(weights))
    want = jloss.weighted_cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
                                        jnp.asarray(weights))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # bf16 ce x f32 weights
    assert abs(float(got) - float(want)) <= 1e-3 * abs(float(want))
