"""The port's fused train steps (parallel/step.make_fused_train_step, the
Solver's fused epoch, train_torch.py --fused_steps) on the CPU, where they
run K eager steps (a CUDA graph needs the card: tests/test_torch_port_gpu.py
holds one graph launch against K eager steps there).

- Against the JAX package's make_fused_train_step(make_mesh(1)): K = 3 steps
  from the same JAX-initialised weights (models/convert), Dropout off, the
  learning rate decaying at the group's second step, within the bounds of
  tests/test_torch_train_step.py (float64: losses rtol 1e-8, per-tensor
  relative L2 1e-7; float32: losses 1e-4, relative L2 worst 5e-2 and median
  1e-3; confusions equal in float64, within 1% of the points in float32).
- Against K calls of the port's own train_step, with Dropout on: equal bit
  for bit (losses, confusions, parameters, BatchNorm statistics, Adam's
  state, the Dropout generator and the step count).
- The learning rate each step applies is the schedule's at that step, a
  staircase boundary inside the group included.
- A Solver epoch at fused_steps=2 (7 scenes, batch 2: one group and one
  leftover step) equals the unfused epoch, on the host path and from the
  device store (the JAX package's tests/test_solver_parallel.py:157-179).
- train_torch.py --fused_steps 2 prints the eager mode line on the CPU and
  keeps the setting on --resume.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.engine import train_state as jts
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.parallel import make_mesh
from pointnet2_scannet_tpu.parallel.step import make_fused_train_step as jax_fused_train_step
from pointnet2_scannet_tpu_torch import config
from pointnet2_scannet_tpu_torch.data import chunks, synthetic
from pointnet2_scannet_tpu_torch.data.pipeline import HostGroup, prefetch_groups
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.solver import Solver
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from pointnet2_scannet_tpu_torch.parallel.step import make_fused_train_step
from tests.test_torch_port_model import SMALL, _randomize_bn
from tests.test_torch_train_step import TOL, _batches, _flat_jax, _x64

ROOT = pathlib.Path(__file__).resolve().parents[1]
K, B, N = 3, 2, 256
LR, DECAY = 1e-3, 0.7
DROPOUT_N = 512  # points a row where Dropout is on


def _stack(batches: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_step_matches_the_jax_fused_step(dtype):
    spec = dict(SMALL, dropout=0.0)
    jspec, pspec = jmodel.PointNet2Spec(**spec), pointnet2.PointNet2Spec(**spec)
    batches = _batches(dtype)  # 3 batches of B x N
    jm = jmodel.PointNet2SemSeg(spec=jspec)
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    variables = _randomize_bn(init(jax.random.PRNGKey(2), jnp.asarray(batches[0]["points"], jnp.float32)), 2)
    # one step an epoch, a decay every 2 epochs: the rate drops at the group's second step
    decay_epochs = 2

    model = pointnet2.PointNet2SemSeg(pspec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(variables, pspec).items()})
    model.to(getattr(torch, dtype))
    state = ts.create_train_state(model, ts.make_lr_schedule(LR, decay_epochs, DECAY, 1), seed=0)
    fused = make_fused_train_step(model, None, num_classes=pspec.num_classes)
    assert fused.mode == "eager"
    out = fused(state, _torch(_stack(batches)))
    assert state.step == K and out["loss"].shape == (K,)
    assert out["confusion"].shape == (K, pspec.num_classes, pspec.num_classes)

    with _x64(dtype == "float64"):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), variables)
        jstate = jts.TrainState.create(
            apply_fn=jm.apply, params=jvars["params"], batch_stats=jvars["batch_stats"],
            tx=jts.make_optimizer(jts.make_lr_schedule(LR, decay_epochs, DECAY, 1)))
        step = jax_fused_train_step(make_mesh(1), num_classes=jspec.num_classes, donate=False)
        jstate, jout = step(jstate, {k: jnp.asarray(v) for k, v in _stack(batches).items()}, jax.random.key(0))
        j_losses, j_cms = np.asarray(jout["loss"]), np.asarray(jout["confusion"])
        final = _flat_jax({"params": jstate.params, "batch_stats": jstate.batch_stats}, pspec)

    tol = TOL[dtype]
    np.testing.assert_allclose(out["loss"].numpy(), j_losses, rtol=tol["loss"])
    for p_cm, j_cm in zip(out["confusion"].numpy(), j_cms):
        assert p_cm.sum() == j_cm.sum() == B * N
        assert np.abs(p_cm - j_cm).sum() / 2 <= tol["cm"] * B * N
    got = {k: v.detach().double().numpy() for k, v in model.state_dict().items()}
    errors = []
    for k, want in final.items():
        if k.endswith("num_batches_tracked"):
            continue
        errors.append(np.linalg.norm(got[k] - want) / np.linalg.norm(want))
        assert errors[-1] <= tol["l2"], (k, errors[-1])
    assert np.median(errors) <= tol["l2_median"]


def _dropout_state(seed: int = 5):
    spec = pointnet2.PointNet2Spec(**dict(SMALL, dropout=0.5))
    model = pointnet2.PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(seed))
    # the rate halves at step 1, inside the group
    return ts.create_train_state(model, ts.make_lr_schedule(LR, 1, 0.5, 1), seed=seed)


def _dropout_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(K):
        pc = np.concatenate([rng.uniform(0, 1.5, (B, DROPOUT_N, 3)),
                             rng.normal(0, 0.5, (B, DROPOUT_N, SMALL["input_channels"]))], -1)
        labels = rng.integers(0, SMALL["num_classes"], (B, DROPOUT_N)).astype(np.int32)
        out.append({"points": pc.astype(np.float32), "labels": labels,
                    "weights": rng.uniform(0.5, 2.0, (B, DROPOUT_N)).astype(np.float32),
                    "row_mask": np.ones(B, np.float32)})
    return out


def _whole_state(state) -> dict:
    opt = state.optimizer
    return {
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "adam": [{k: v.clone() for k, v in opt.state[p].items()} for p in state.model.parameters()],
        "generator": state.generator.get_state(),
        "step": state.step,
    }


def _assert_same(a: dict, b: dict) -> None:
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for x, y in zip(a["adam"], b["adam"]):
        for k, v in x.items():
            assert torch.equal(v, y[k]), k


@pytest.mark.parametrize("feed", ["tensors", "host_group"])
def test_fused_steps_equal_sequential_steps_bit_for_bit_with_dropout(feed):
    batches = _dropout_batches()
    seq, fused_state = _dropout_state(), _dropout_state()
    want = [ts.train_step(seq, _torch(b), num_classes=SMALL["num_classes"]) for b in batches]
    fused = make_fused_train_step(fused_state.model, None, num_classes=SMALL["num_classes"])
    group = HostGroup(batches) if feed == "host_group" else _torch(_stack(batches))
    got = fused(fused_state, group)
    assert torch.equal(got["loss"], torch.stack([w["loss"] for w in want]))
    assert torch.equal(got["confusion"], torch.stack([w["confusion"] for w in want]))
    _assert_same(_whole_state(fused_state), _whole_state(seq))
    assert seq.model.spec.dropout == 0.5


def test_each_step_takes_the_schedules_rate_inside_a_group():
    state = _dropout_state()
    applied = []
    step = state.optimizer.step

    def recorded(*args, **kwargs):
        applied.append(state.optimizer.param_groups[0]["lr"])
        return step(*args, **kwargs)

    state.optimizer.step = recorded
    fused = make_fused_train_step(state.model, None, num_classes=SMALL["num_classes"])
    fused(state, _torch(_stack(_dropout_batches())))
    fused(state, _torch(_stack(_dropout_batches())))
    assert applied == [state.schedule(s) for s in range(2 * K)] == [LR * 0.5 ** s for s in range(2 * K)]


def test_host_groups_stack_k_batches_and_pass_the_leftover():
    batches = _dropout_batches() + _dropout_batches()[:2]
    items = list(prefetch_groups(iter(batches), 2, device="cpu"))
    assert [type(i).__name__ for i in items] == ["HostGroup", "HostGroup", "dict"]
    for g, pair in zip(items[:2], (batches[:2], batches[2:4])):
        assert g.k == 2 and g.layout.nbytes == g.buffer.numel()
        for name, arr in g.arrays.items():
            assert arr.dtype == torch.from_numpy(pair[0][name]).dtype
            np.testing.assert_array_equal(arr.numpy(), np.stack([b[name] for b in pair]))
    assert items[2] is batches[4]


# --- the Solver's fused epoch

SPEC = dict(SMALL, input_channels=6, num_classes=20, dropout=0.5)
DATA = dict(npoints=DROPOUT_N, use_color=True, use_normal=True)


def _solver(store, tmp_path, fused_steps, device_store, name):
    cfg = config.RunConfig(tag="fused", data=config.DataConfig(**DATA), train=config.TrainConfig(
        batch_size=2, epochs=1, verbose=1, seed=0, fused_steps=fused_steps, device_store=device_store))
    ds = chunks.ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**SPEC), generator=torch.Generator().manual_seed(0))
    return Solver(model, ds, None, cfg, tmp_path / name, device="cpu")


@pytest.mark.parametrize("device_store", [False, True], ids=["host", "device_store"])
def test_fused_solver_epoch_equals_the_unfused_epoch(tmp_path, monkeypatch, capsys, device_store):
    store = synthetic.make_synthetic_store(7, seed=0, n_points=3000)
    steps, stats, params = {}, {}, {}
    step = ts.train_step

    def recorded(state, batch, **kw):  # the fused steps and resident_train_step call it too
        out = step(state, batch, **kw)
        steps.setdefault(name, []).append((float(out["loss"]), out["confusion"].clone()))
        return out

    monkeypatch.setattr(ts, "train_step", recorded)
    for name, k in (("fused", 2), ("plain", 1)):
        solver = _solver(store, tmp_path, k, device_store, name)
        assert solver.device_store == device_store
        assert (solver._fused_step is not None) == (k > 1)
        solver._start_epoch(0, 1)
        stats[name] = solver._run_train_epoch(0, 1, 1, 0.0)
        assert solver.state.step == len(solver.train_loader) == 3
        params[name] = {k: v.clone() for k, v in solver.model.state_dict().items()}
    out = capsys.readouterr().out
    assert "device_store disabled" not in out
    # one report a group and one for the leftover step: iters 2 and 3
    assert [line.split("iter [")[1].split("]")[0] for line in out.splitlines() if "iter [" in line] == [
        "2/3", "3/3", "1/3", "2/3", "3/3"]
    assert stats["fused"] == stats["plain"]
    assert [s[0] for s in steps["fused"]] == [s[0] for s in steps["plain"]]
    assert all(torch.equal(a[1], b[1]) for a, b in zip(steps["fused"], steps["plain"]))
    for k, v in params["plain"].items():
        assert torch.equal(params["fused"][k], v), k


# --- train_torch.py --fused_steps

CLI = ["--device", "cpu", "--synthetic", "--synthetic_scenes", "5", "--npoints", "256", "--batch_size", "2",
       "--verbose", "2", "--use_color", "--use_normal"]


def _train(argv):
    spec = importlib.util.spec_from_file_location("train_torch", ROOT / "scripts" / "train_torch.py")
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run, _ = train_torch.train(train_torch.parse_args(argv))
    return run, out.getvalue()


def test_train_torch_fused_steps_prints_the_eager_mode_and_keeps_it_on_resume(tmp_path):
    run, out = _train(CLI + ["--epoch", "1", "--fused_steps", "2", "--output_root", str(tmp_path)])
    line = "2 steps per epoch, fused_steps 2: 2 eager steps per group (cpu), compute dtype float32"
    assert line in out
    assert json.loads((run / "config.json").read_text())["train"]["fused_steps"] == 2
    _, resumed = _train(CLI + ["--epoch", "2", "--resume", str(run)])
    assert line in resumed and "epoch [2/2] done" in resumed
    _, plain = _train(CLI + ["--epoch", "3", "--resume", str(run), "--fused_steps", "1"])
    assert "2 steps per epoch, one step per batch" in plain
    assert json.loads((run / "config.json").read_text())["train"]["fused_steps"] == 1
