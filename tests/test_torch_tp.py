"""The port's tensor parallelism (pointnet2_scannet_tpu_torch/parallel/mesh.py,
the channel-split layers of models/) on gloo CPU ranks, against the JAX
package's single-device train_step and the port's single-process step on
the same global batch.

One spawn of four ranks (tests/torch_tp_worker.py, joined under its own
timeout and killed past it) computes every tensor-parallel case, on a 2 x 2
grid and on dp 1 x tp 2 (the tp groups of that world); the tests read what
each rank wrote. The yardstick is the JAX single-device train_step (the
JAX "gspmd_dp_tp" step is that function's math partitioned by GSPMD).

Train steps run in float64 with Dropout off on two small models: SSG with
6 classes (its 6-class head split at tp 2) and MSG with 5 (its head whole
at tp 2); every other width is even. Bounds: those tests/test_torch_parallel.py
holds data parallelism to, per-tensor relative L2 of 1e-6 on the gradients,
statistics and parameters, the loss relative, the confusion exact. A split
Linear sums each output channel as the whole one does; what moves is the
summation order of the matmuls over narrower weights and of the input's
cotangent, summed over the tp ranks. Measured, per-tensor relative L2 of
the gradients at the worst tensor: 1.2-1.9e-14 from the port's
single-process step, and 7.3-8.5e-8 from the JAX step, as the
single-process step is (tests/test_torch_parallel.py says why). The
negative controls sit far past the bound: the column-parallel input's
backward without its tp all-reduce 1.13, BatchNorm statistics summed over
the tp group instead of the dp group 3.57.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnet2_scannet_tpu.engine import train_state as jts
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.parallel import mesh as jmesh
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.solver import _SceneBatchIterator
from pointnet2_scannet_tpu_torch.models import convert, layers, pointnet2
from pointnet2_scannet_tpu_torch.parallel import distributed as D
from pointnet2_scannet_tpu_torch.parallel import mesh
from tests import torch_tp_worker as W
from tests.test_torch_msg_port import SMALL_MSG
from tests.test_torch_port_model import SMALL, _randomize_bn

B, N = 4, 256
KINDS = ("ssg", "msg")
SPECS = {"ssg": dict(SMALL, num_classes=6, dropout=0.0), "msg": dict(SMALL_MSG, dropout=0.0)}
CASES = [(grid, kind) for grid in W.GRIDS for kind in KINDS]
STEP_TOL = 1e-6  # tests/test_torch_parallel.py's bound
TP = 2


def _ids(case):
    return "-".join(case)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _worst(got: dict, want: dict) -> tuple[float, str]:
    assert set(got) == set(want)
    return max((_rel_l2(got[k], want[k]), k) for k in want)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@functools.cache
def _variables(kind: str):
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**SPECS[kind]))
    x = jnp.zeros((1, N, 3 + SPECS[kind]["input_channels"]), jnp.float32)
    return _randomize_bn(jax.jit(lambda k: jm.init(k, x, train=False))(jax.random.PRNGKey(3)), 3)


def _state_dict(kind: str) -> dict:
    return {k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(
        _variables(kind), pointnet2.PointNet2Spec(**SPECS[kind])).items()}


def _batch() -> dict:
    rng = np.random.default_rng(7)
    pc = np.concatenate([rng.uniform(0, 1.5, (B, N, 3)), rng.normal(0, 0.5, (B, N, 3))], -1)
    labels = rng.integers(0, 5, (B, N))
    weights = (1.0 / np.log(1.2 + rng.dirichlet(np.ones(6))))[labels]
    return {"points": pc, "labels": labels.astype(np.int64), "weights": weights, "row_mask": np.ones(B)}


def _micro_batches() -> list:
    """One scene of 3 columns at micro-batch 2: the second is padded, and
    its rows on dp rank 1 are padding alone."""
    rng = np.random.default_rng(5)
    feats = np.concatenate([rng.uniform(0, 1.5, (3, N, 3)), rng.normal(0, 0.5, (3, N, 3))], -1)
    labels = rng.integers(0, 6, (3, N)).astype(np.int64)
    weights = rng.uniform(0.5, 2.0, (3, N))
    return list(_SceneBatchIterator(None, 2).micro_batches(feats, labels, weights))


def _pregather_case() -> dict:
    """One MLP (widths 8, 16) over 35 input channels (3 xyz + 32), the
    pregather form, its weights and cotangent drawn with numpy."""
    rng = np.random.default_rng(13)
    mlp = layers.PointwiseMLP(35, (8, 16))
    state = {k: torch.from_numpy(rng.normal(0.0, 0.3, tuple(v.shape)) if v.is_floating_point() else v.numpy())
             for k, v in mlp.state_dict().items()}
    state = {k: (v.abs() + 0.5 if "running_var" in k else v) for k, v in state.items()}
    xyz = rng.uniform(0, 1, (2, 64, 3))
    idx = rng.integers(0, 64, (2, 16, 8))
    return {"c_in": 35, "widths": (8, 16), "state": state, "xyz": torch.from_numpy(xyz),
            "new_xyz": torch.from_numpy(xyz[:, :16]), "features": torch.from_numpy(rng.normal(size=(2, 64, 32))),
            "idx": torch.from_numpy(idx), "cot": torch.from_numpy(rng.normal(size=(2, 16, 8, 16)))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the ranks pin theirs too): these small shapes gain
    nothing from more, which would only contend with the other workers of a
    parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every rank's results (spawned once for the module) and the inputs."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = {
        "batch": {k: torch.from_numpy(v) for k, v in _batch().items()},
        "micro_batches": _micro_batches(),
        "pregather": _pregather_case(),
    }
    for kind in KINDS:
        inputs[f"{kind}_spec"], inputs[f"{kind}_state"] = SPECS[kind], _state_dict(kind)
    torch.save(inputs, tmp / "inputs.pt")
    D.spawn(W.run_scenarios, W.WORLD, (str(tmp), D.free_port()), timeout=W.TIMEOUT_S)
    return inputs, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(W.WORLD)], tmp


def _single_state(kind: str) -> ts.TrainState:
    model = W.port_model(SPECS[kind], _state_dict(kind))
    return ts.create_train_state(model, ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=0)


@functools.cache
def _single_step(kind: str) -> dict:
    """The port's single-process step on the whole batch."""
    state = _single_state(kind)
    grid = mesh.Grid(1, 1, 0, 0)
    state.shardings = dict.fromkeys(mesh.train_state_shardings(state.model, 1), False)
    return W.step_result(state, grid, {k: torch.from_numpy(v) for k, v in _batch().items()})


@functools.cache
def _jax_step(kind: str) -> dict:
    """The JAX single-device train_step on the whole batch in float64, under
    SGD with rate 1, so that the parameters move by minus the gradient; and
    the train-mode logits of the same forward."""
    pspec = pointnet2.PointNet2Spec(**SPECS[kind])
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**SPECS[kind]))
    batch = _batch()
    with _x64():
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), _variables(kind))
        state = jts.TrainState.create(apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
                                      tx=optax.sgd(1.0))
        step = jax.jit(functools.partial(jts.train_step, num_classes=pspec.num_classes))
        new, out = step(state, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.key(0))
        logits, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(batch["points"]))
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), v["params"], new.params)
        sd = convert.state_dict_from_jax({"params": grads, "batch_stats": new.batch_stats}, pspec)
        loss, cm, logits = float(out["loss"]), np.asarray(out["confusion"]), np.asarray(logits)
    params = {k for k, _ in pointnet2.PointNet2SemSeg(pspec).named_parameters()}
    return {"loss": loss, "confusion": cm, "logits": logits, "grads": {k: v for k, v in sd.items() if k in params},
            "stats": {k: v for k, v in sd.items() if "running_" in k}}


def _check_step(got: dict, rank: int, grid: str, want: dict) -> None:
    """One rank's step against a single-device step: its logits against that
    step's logits of the rank's dp rows."""
    err, name = _worst(got["grads"], want["grads"])
    assert err <= STEP_TOL, (name, err)
    assert abs(got["loss"] - want["loss"]) <= STEP_TOL * abs(want["loss"])
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert _worst({k: got["stats"][k] for k in want["stats"]}, want["stats"])[0] <= STEP_TOL
    rows = B // 2 if grid == "2x2" else B
    first = rank // 2 * rows if grid == "2x2" else 0
    assert got["logits"].shape == (rows, N, SPECS["ssg" if want["logits"].shape[-1] == 6 else "msg"]["num_classes"])
    assert _rel_l2(got["logits"], want["logits"][first : first + rows]) <= STEP_TOL


# ------------------------------------------------------------ the train step


@pytest.mark.parametrize("grid,kind", CASES, ids=map(_ids, CASES))
def test_tp_step_matches_the_jax_single_device_train_step(tp, grid, kind):
    _, ranks, _ = tp
    want = _jax_step(kind)
    for rank, r in enumerate(ranks):
        _check_step(r["steps"][grid, kind], rank, grid, want)


@pytest.mark.parametrize("grid,kind", CASES, ids=map(_ids, CASES))
def test_tp_step_matches_the_port_single_process_step(tp, grid, kind):
    _, ranks, _ = tp
    want = _single_step(kind)
    for rank, r in enumerate(ranks):
        got = r["steps"][grid, kind]
        _check_step(got, rank, grid, want)
        assert _worst(got["params"], want["params"])[0] <= STEP_TOL
        for k, moments in want["adam"].items():
            assert _worst(got["adam"][k], moments)[0] <= STEP_TOL, k


@pytest.mark.parametrize("grid,kind", CASES, ids=map(_ids, CASES))
def test_every_rank_gathers_the_same_whole_state(tp, grid, kind):
    _, ranks, _ = tp
    first = ranks[0]["steps"][grid, kind]
    for r in ranks[1:]:
        got = r["steps"][grid, kind]
        for part in ("params", "stats"):
            for k, v in first[part].items():
                np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part}.{k}")


# -------------------------------------------------------------- the layout


@pytest.mark.parametrize("kind", KINDS)
def test_each_rank_holds_its_slice_and_the_adam_moments_follow(tp, kind):
    _, ranks, _ = tp
    model = W.port_model(SPECS[kind])
    whole = {k: t.numel() for k, t in [*model.named_parameters(), *model.named_buffers()]}
    heads = {"ssg": True, "msg": False}  # 6 classes split at tp 2, 5 stay whole
    for r in ranks:
        lay = r["layout"][kind]
        split = lay["shardings"]
        assert split == mesh.train_state_shardings(model, TP)
        assert split["cls_out.dense_0.weight"] is heads[kind] and split["cls_out.bn_0.running_var"] is heads[kind]
        assert split["sa_0.mlp_0.dense_0.weight"] and not split["sa_0.mlp_0.bn_0.num_batches_tracked"]
        for k, n in whole.items():
            assert lay["leaves"][k] == (n // TP if split[k] else n), k
        for k, moments in lay["adam"].items():
            assert moments == {"step": 1, "exp_avg": lay["leaves"][k], "exp_avg_sq": lay["leaves"][k]}, k
        assert sum(lay["leaves"].values()) < sum(whole.values())


def _marked(tree, mesh_, kind_spec) -> dict:
    """JAX's train_state_shardings of a variables tree, as the port's names:
    1 where a leaf's spec names the tp axis."""
    shard = jmesh.train_state_shardings(tree, mesh_)
    marks = jax.tree_util.tree_map(
        lambda leaf, s: np.full(leaf.shape, float("tp" in tuple(s.spec)), np.float64), tree, shard)
    sd = convert.state_dict_from_jax(marks, kind_spec)
    return {k: bool(v.all()) for k, v in sd.items() if v.dtype == np.float64 and v.size}


@pytest.mark.parametrize("spec", ["small_ssg", "small_msg", "ssg_20", "msg_20"])
@pytest.mark.parametrize("tp_size", [2, 4])
def test_leaf_rule_is_the_jax_train_state_shardings(spec, tp_size):
    kwargs = {"small_ssg": SPECS["ssg"], "small_msg": SPECS["msg"],
              "ssg_20": dataclasses.asdict(jmodel.ssg_spec(20, 6)),
              "msg_20": dataclasses.asdict(jmodel.msg_spec(20, 6))}[spec]
    pspec = pointnet2.PointNet2Spec(**kwargs)
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**kwargs))
    x = jnp.zeros((1, 128, 3 + pspec.input_channels), jnp.float32)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    want = _marked({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                   jmesh.make_mesh_2d(8 // tp_size, tp_size), pspec)
    got = mesh.train_state_shardings(pointnet2.PointNet2SemSeg(pspec), tp_size)
    assert {k: got[k] for k in want} == want
    if spec.endswith("_20"):  # the 20-class head splits at tp 2 and 4
        assert got["cls_out.dense_0.weight"] and got["cls_out.bn_0.bias"]


def test_grid_coordinates_follow_the_jax_reshape(tp):
    _, ranks, _ = tp
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 1), (1, 0, 0), (1, 1, 1)]


# ------------------------------------------------------- negative controls


@pytest.mark.parametrize("broken", ["no_tp_all_reduce", "bn_over_tp"])
def test_negative_controls_fail_the_gradient_bound(tp, broken):
    _, ranks, _ = tp
    for want in (_single_step("ssg"), _jax_step("ssg")):
        for r in ranks:
            err, _ = _worst(r["broken"][broken], want["grads"])
            assert err > 100 * STEP_TOL, err


# --------------------------------------- whole scenes, eval, pregather, files


@pytest.mark.parametrize("grid", W.GRIDS)
def test_wholescene_update_with_masked_batch_norm_equals_the_single_process_update(tp, grid):
    inputs, ranks, _ = tp
    assert [mb["row_mask"].tolist() for mb in inputs["micro_batches"]] == [[1, 1], [1, 0]]
    state = _single_state("ssg")
    loss_sum = count = 0.0
    for mb in inputs["micro_batches"]:
        batch = {k: torch.from_numpy(v) for k, v in mb.items()}
        res = ts.grad_accum_step(state, {k: v.double() if v.is_floating_point() else v for k, v in batch.items()},
                                 num_classes=SPECS["ssg"]["num_classes"])
        loss_sum, count = loss_sum + float(res["loss_sum"]), count + float(res["count"])
    ts.apply_accumulated(state, count)
    want = {k: v.double().numpy() for k, v in state.model.state_dict().items() if v.is_floating_point()}
    for r in ranks:
        ws = r["wholescene"][grid]
        assert ws["count"] == count == 3 * N
        assert abs(ws["loss_sum"] - loss_sum) <= STEP_TOL * abs(loss_sum)
        assert _worst(ws["state"], want)[0] <= STEP_TOL


def test_eval_confusion_equals_the_single_process_eval(tp):
    _, ranks, _ = tp
    state = _single_state("ssg")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ts.train_step(state, batch, num_classes=6)
    want = ts.eval_step(state.model, batch, num_classes=6)
    for r in ranks:
        np.testing.assert_array_equal(r["eval"]["confusion"], want["confusion"].numpy())
        assert abs(r["eval"]["loss"] - float(want["loss"])) <= STEP_TOL * abs(float(want["loss"]))
    np.testing.assert_array_equal(np.concatenate([ranks[0]["eval"]["preds"], ranks[2]["eval"]["preds"]]),
                                  want["preds"].numpy())


def test_pregather_split_over_tp_equals_the_whole_mlp(tp):
    inputs, ranks, _ = tp
    case = inputs["pregather"]
    mlp = layers.PointwiseMLP(case["c_in"], case["widths"])
    mlp.load_state_dict(case["state"])
    mlp = mlp.double().train()
    feats = case["features"].clone().requires_grad_(True)
    y = mlp.pregather(case["xyz"], feats, case["idx"], case["new_xyz"])
    (y * case["cot"]).sum().backward()
    for r in ranks:
        got = r["pregather"]
        assert _rel_l2(got["y"], y.detach().numpy()) <= STEP_TOL
        assert _rel_l2(got["dfeatures"], feats.grad.numpy()) <= STEP_TOL
        assert _worst(got["grads"], {k: p.grad.numpy() for k, p in mlp.named_parameters()})[0] <= STEP_TOL
        assert _worst(got["stats"], {k: b.numpy() for k, b in mlp.named_buffers() if "running_" in k})[0] <= STEP_TOL


def test_checkpoint_round_trip_through_tp_1_is_tensor_equal(tp):
    _, ranks, tmp = tp
    for r in ranks:
        assert r["checkpoint"]["differ"] == [] and r["checkpoint"]["step"] == 1
    # the tp-2 file and the tp-1 file hold the same tensors, in the tp-1 format
    from pointnet2_scannet_tpu_torch.engine import checkpoint

    a, b = checkpoint.load_state_dict(tmp / "tp2", "model_last"), checkpoint.load_state_dict(tmp / "tp1", "model_last")
    assert set(a) == set(b) == set(W.port_model(SPECS["msg"]).state_dict())
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
    whole = sum(p.numel() for p in W.port_model(SPECS["msg"]).parameters())
    assert all(r["checkpoint"]["numel"] < whole for r in ranks)
