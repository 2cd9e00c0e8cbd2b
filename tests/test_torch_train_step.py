"""The port's train step against the JAX package's production train_step
(pointnet2_scannet_tpu.engine.train_state.train_step) over a trajectory, for
a small SSG model and a small MSG model (whose second level takes the
pregather composition in float32, in both packages).

Both start from the same JAX-initialised weights (BatchNorm statistics
randomised), moved by models/convert.state_dict_from_jax, with Dropout off
(the two frameworks' random streams cannot match), and take 6 optimizer
steps on the same cycle of 3 batches. The learning rate decays once, at step
3 (1 step per epoch, decay every 3 epochs). Per-step learning rates, losses
and confusion matrices, then the final parameters and BatchNorm running
statistics, are compared. The bounds, and why they are not tighter:

- float64: both models cast their logits to float32 (the JAX model's last
  line), so the softmax of the loss runs in float32 in both frameworks, and
  XLA's and PyTorch's float32 exp differ by an ulp. Every index the ops pick
  is identical and the forward at step 0 is bit-equal, but from step 1 on
  the losses differ by up to 4e-9 relative and the parameters by up to 4e-8
  in per-tensor relative L2 (measured). Bounds: losses rtol 1e-8, per-tensor
  relative L2 1e-7, elementwise atol 1e-6; the confusion matrices are equal.
- float32: reduction orders differ too (~1e-7 a step), and two effects
  amplify them over 6 steps: Adam's first updates are lr * sign(grad), so a
  gradient near 0 can move a weight by +lr or -lr; and a max over K
  neighbours sends the whole gradient to whichever value is larger, so a
  one-ulp change reroutes it. Measured: losses 4.8e-5 relative, per-tensor
  relative L2 median 5.6e-5 and worst 1.3e-2 (a BatchNorm bias), one point
  of 512 predicted differently at step 5. Bounds: losses rtol 1e-4,
  per-tensor relative L2 median 1e-3 and worst 5e-2, confusion matrices
  within 1% of the points.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.engine import train_state as jts
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from tests.test_torch_msg_port import SMALL_MSG
from tests.test_torch_port_model import SMALL, _randomize_bn

B, N, STEPS, DECAY_EPOCHS, DECAY, LR = 2, 256, 6, 3, 0.7, 1e-3
# losses rtol, per-tensor relative L2 (worst, median), elementwise atol, confusion tolerance
TOL = {
    "float64": dict(loss=1e-8, l2=1e-7, l2_median=1e-7, atol=1e-6, cm=0.0),
    "float32": dict(loss=1e-4, l2=5e-2, l2_median=1e-3, atol=None, cm=0.01),
}


@contextlib.contextmanager
def _x64(enabled: bool):
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _batches(dtype):
    rng = np.random.default_rng(21)
    label_weights = 1.0 / np.log(1.2 + rng.dirichlet(np.ones(SMALL["num_classes"])))
    out = []
    for _ in range(3):
        pc = np.concatenate(
            [rng.uniform(0, 1.5, (B, N, 3)), rng.normal(0, 0.5, (B, N, SMALL["input_channels"]))], -1
        )
        labels = rng.integers(0, SMALL["num_classes"], (B, N)).astype(np.int32)
        out.append({
            "points": pc.astype(dtype),
            "labels": labels,
            "weights": label_weights[labels].astype(dtype),
            "row_mask": np.ones(B, dtype),
        })
    return out


def _flat_jax(variables, pspec):
    return {k: np.asarray(v, np.float64) for k, v in convert.state_dict_from_jax(variables, pspec).items()}


@pytest.mark.parametrize(
    "spec,dtype",
    [("ssg", "float64"), ("ssg", "float32"), ("msg", "float64"), ("msg", "float32")],
    ids=["float64", "float32", "msg-float64", "msg-float32"],
)
def test_train_trajectory_matches_jax_train_step(spec, dtype):
    spec_kwargs = dict(SMALL if spec == "ssg" else SMALL_MSG, dropout=0.0)
    jspec, pspec = jmodel.PointNet2Spec(**spec_kwargs), pointnet2.PointNet2Spec(**spec_kwargs)
    batches = _batches(dtype)
    jm = jmodel.PointNet2SemSeg(spec=jspec)
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = _randomize_bn(init(jax.random.PRNGKey(2), jnp.asarray(batches[0]["points"], jnp.float32)), 2)

    # the port: the same weights, its train_step
    model = pointnet2.PointNet2SemSeg(pspec)
    state_dict = convert.state_dict_from_jax(variables, pspec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    model.to(getattr(torch, dtype))
    schedule = ts.make_lr_schedule(LR, DECAY_EPOCHS, DECAY, 1)
    state = ts.create_train_state(model, schedule, seed=0)
    p_losses, p_lrs, p_cms = [], [], []
    for step in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in batches[step % 3].items()}
        p_lrs.append(schedule(state.step))
        out = ts.train_step(state, batch, num_classes=pspec.num_classes)
        p_losses.append(float(out["loss"]))
        p_cms.append(out["confusion"].numpy())
    assert state.step == STEPS

    # the JAX package: the production train_step, jitted
    with _x64(dtype == "float64"):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), variables)
        jschedule = jts.make_lr_schedule(LR, DECAY_EPOCHS, DECAY, 1)
        jstate = jts.TrainState.create(
            apply_fn=jm.apply, params=jvars["params"], batch_stats=jvars["batch_stats"],
            tx=jts.make_optimizer(jschedule),
        )
        step_fn = jax.jit(lambda s, b, r: jts.train_step(s, b, r, num_classes=jspec.num_classes))
        j_losses, j_lrs, j_cms = [], [], []
        for step in range(STEPS):
            j_lrs.append(float(jschedule(step)))
            jstate, out = step_fn(jstate, {k: jnp.asarray(v) for k, v in batches[step % 3].items()},
                                  jax.random.key(0))
            j_losses.append(float(out["loss"]))
            j_cms.append(np.asarray(out["confusion"]))
        final = _flat_jax({"params": jstate.params, "batch_stats": jstate.batch_stats}, pspec)

    tol = TOL[dtype]
    assert p_lrs[2] == LR and p_lrs[3] == pytest.approx(LR * DECAY)  # one decay, at step 3
    np.testing.assert_allclose(p_lrs, j_lrs, rtol=1e-7 if dtype == "float32" else 1e-15)
    np.testing.assert_allclose(p_losses, j_losses, rtol=tol["loss"])
    for p_cm, j_cm in zip(p_cms, j_cms):
        assert p_cm.sum() == j_cm.sum() == B * N
        assert np.abs(p_cm - j_cm).sum() / 2 <= tol["cm"] * B * N
    got = {k: v.detach().double().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(final)
    moved, errors = 0, []
    for k, want in final.items():
        if k.endswith("num_batches_tracked"):
            continue
        errors.append(np.linalg.norm(got[k] - want) / np.linalg.norm(want))
        assert errors[-1] <= tol["l2"], (k, errors[-1])
        if tol["atol"] is not None:
            np.testing.assert_allclose(got[k], want, rtol=0, atol=tol["atol"], err_msg=k)
        moved += not np.array_equal(want, np.asarray(state_dict[k], np.float64))
    assert np.median(errors) <= tol["l2_median"]
    assert moved == len(final) - sum(k.endswith("num_batches_tracked") for k in final)


def test_train_forward_dropout_is_seeded_and_scaled():
    spec = pointnet2.PointNet2Spec(**dict(SMALL, dropout=0.5))
    model = pointnet2.PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(0))
    pc = torch.from_numpy(_batches("float32")[0]["points"])
    model.train()
    a = model(pc, torch.Generator().manual_seed(5))
    b = model(pc, torch.Generator().manual_seed(5))
    c = model(pc, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(pc)
    # the head's Dropout keeps about half and scales the kept by 2
    h = torch.ones(4, 1000, 16)
    kept = pointnet2._dropout(h, 0.5, torch.Generator().manual_seed(1))
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert 0.45 < float((kept > 0).float().mean()) < 0.55
    model.eval()
    torch.testing.assert_close(model(pc), model(pc, torch.Generator().manual_seed(9)))


def test_lr_schedule_and_coupled_weight_decay():
    schedule = ts.make_lr_schedule(1e-3, 2, 0.5, 3)  # decays every 6 steps
    assert [schedule(s) for s in (0, 5, 6, 11, 12)] == [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4]
    assert ts.make_lr_schedule(1e-3, 0, 0.5, 0)(1) == 5e-4  # transition clamps to 1 step
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    opt = ts.make_optimizer([p], 0.1, weight_decay=0.5)
    p.grad = torch.zeros(3, dtype=torch.float64)
    opt.step()
    # coupled L2: the decay enters the gradient (g = 0.5 * 1), so Adam's first
    # step moves every weight by -lr * g / (|g| + eps)
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 * 0.5 / (0.5 + 1e-8), rtol=1e-15)
