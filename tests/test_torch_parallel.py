"""The port's data parallelism (pointnet2_scannet_tpu_torch/parallel/) on two
gloo CPU ranks, against the port's single-process functions and the JAX
package's single-device ones on the concatenated global batch.

One spawn of two ranks (tests/torch_dp_worker.py, joined under its own
timeout and killed past it) computes every data-parallel case; the tests
read what each rank wrote. The yardstick is the JAX single-device
train_step, not the JAX shard_map step: that one multiplies its gradient by
the device count (ROADMAP, latent reference issues), which the port does
not copy.

Train steps run in float64 with Dropout off, on the small SSG model (the
MSG model passed the same bounds, 1.8e-14 and 7.3e-8, but its JAX step's
compile does not fit the files' time budget). Measured, per-tensor relative
L2 of the gradients at the worst tensor: the two-rank step sits 1.3e-14
from the port's single-process step (its BatchNorm sums and gradients add
in another order), and 9.3e-8 from the JAX step, as the single-process
step does: both models cast their logits to
float32 (the JAX model's last line), so the loss's softmax runs in float32
in both frameworks, whose exp differ by an ulp. Bound: 1e-6. The negative
controls sit far past it: the gradient all-reduce left out 3.4-4.0, a
BatchNorm all-reduce whose backward keeps each rank's cotangent 2.9, the
gradient doubled 1.0.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnet2_scannet_tpu.data import scene_store as jstore
from pointnet2_scannet_tpu.engine import train_state as jts
from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.parallel.distributed import strided_shard as jstrided_shard
from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore, weights_from_counts, label_counts
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.evaluator import pack_scene_results
from pointnet2_scannet_tpu_torch.engine.solver import _SceneBatchIterator
from pointnet2_scannet_tpu_torch.models import convert, layers, pointnet2
from pointnet2_scannet_tpu_torch.parallel import distributed as D
from tests import torch_dp_worker as W
from tests.test_torch_port_model import SMALL, _randomize_bn

B, N, CLASSES = 4, 256, 5
KINDS = ("ssg",)  # MSG would add ~8 s (its JAX step's compile) past the files' budget
STEP_TOL = 1e-6  # per-tensor relative L2 of gradients, statistics, parameters; loss relative
BN_TOL = 1e-6  # MaskedBatchNorm, float32: relative to the largest magnitude
SCENES = 5  # .npy scenes of the sharded-loading case (equalize drops one)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


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


def _spec(kind: str) -> dict:
    return dict(SMALL, dropout=0.0)


@functools.cache
def _variables(kind: str):
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**_spec(kind)))
    x = jnp.zeros((1, N, 3 + SMALL["input_channels"]), jnp.float32)
    return _randomize_bn(jax.jit(lambda k: jm.init(k, x, train=False))(jax.random.PRNGKey(3)), 3)


def _batch():
    rng = np.random.default_rng(7)
    pc = np.concatenate([rng.uniform(0, 1.5, (B, N, 3)), rng.normal(0, 0.5, (B, N, SMALL["input_channels"]))], -1)
    labels = rng.integers(0, CLASSES, (B, N))
    weights = (1.0 / np.log(1.2 + rng.dirichlet(np.ones(CLASSES))))[labels]
    return {"points": pc, "labels": labels.astype(np.int64), "weights": weights, "row_mask": np.ones(B)}


def _masked_bn_cases():
    """(x, mask, cotangent, BatchNorm parameters) per case, 6 rows over two
    ranks of 3: rank 1's rows all padding, or 1 and 2 real rows."""
    rng = np.random.default_rng(11)
    out = {}
    for case, mask in (("all_padding_rank", [1, 1, 1, 0, 0, 0]), ("unequal_rows", [1, 0, 0, 1, 1, 0])):
        mask = np.asarray(mask, np.float32)
        x = rng.normal(0.7, 1.3, (6, 16, 8)).astype(np.float32) * mask[:, None, None]
        params = {"weight": rng.uniform(0.5, 1.5, 8), "bias": rng.normal(0, 0.1, 8),
                  "running_mean": rng.normal(0, 0.1, 8), "running_var": rng.uniform(0.5, 2.0, 8)}
        out[case] = tuple(torch.from_numpy(a) for a in (x, mask, rng.normal(size=x.shape).astype(np.float32))) + (
            {k: torch.from_numpy(v.astype(np.float32)) for k, v in params.items()},)
    return out


def _micro_batches():
    """One scene of 3 columns at micro-batch 2: the second is padded, and
    its row on rank 1 is padding alone."""
    rng = np.random.default_rng(5)
    feats = np.concatenate([rng.uniform(0, 1.5, (3, N, 3)), rng.normal(0, 0.5, (3, N, 3))], -1).astype(np.float32)
    labels = rng.integers(0, CLASSES, (3, N)).astype(np.int64)
    weights = rng.uniform(0.5, 2.0, (3, N)).astype(np.float32)
    return list(_SceneBatchIterator(None, 2).micro_batches(feats, labels, weights))


def _scene_ids(tmp):
    (tmp / "scenes").mkdir()
    rng = np.random.default_rng(9)
    ids = [f"scene{i:04d}_00" for i in range(SCENES)]
    for i, sid in enumerate(ids):
        scene = rng.normal(size=(100 + 40 * i, 11))
        scene[:, 10] = rng.integers(0, CLASSES, scene.shape[0]) if i != SCENES - 1 else 4  # the tail: one class
        np.save(tmp / "scenes" / f"{sid}.npy", scene)
    return ids


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
def dp(tmp_path_factory):
    """Every rank's results (spawned once for the module) and the inputs."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs = {
        "kinds": KINDS,
        "batch": {k: torch.from_numpy(v) for k, v in _batch().items()},
        "masked_bn": _masked_bn_cases(),
        "micro_batches": _micro_batches(),
        "scene_ids": _scene_ids(tmp),
    }
    for kind in KINDS:
        inputs[f"{kind}_spec"], inputs[f"{kind}_state"] = _spec(kind), _state_dict(kind)
    torch.save(inputs, tmp / "inputs.pt")
    D.spawn(W.run_scenarios, W.WORLD, (str(tmp), D.free_port()), timeout=W.TIMEOUT_S)
    return inputs, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(W.WORLD)], tmp


def _state_dict(kind: str) -> dict:
    return {k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(
        _variables(kind), pointnet2.PointNet2Spec(**_spec(kind))).items()}


@functools.cache
def _single_step(kind: str) -> dict:
    """The port's single-process step on the whole batch."""
    model = W.port_model(_spec(kind), _state_dict(kind), torch.float64)
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    return W.step_result(state, ts.train_step(state, batch, num_classes=CLASSES))


@functools.cache
def _jax_step(kind: str) -> dict:
    """The JAX single-device train_step on the whole batch in float64, under
    SGD with rate 1, so that the parameters move by minus the gradient."""
    pspec = pointnet2.PointNet2Spec(**_spec(kind))
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**_spec(kind)))
    with _x64():
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), _variables(kind))
        state = jts.TrainState.create(apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
                                      tx=optax.sgd(1.0))
        step = jax.jit(functools.partial(jts.train_step, num_classes=CLASSES))
        new, out = step(state, {k: jnp.asarray(a) for k, a in _batch().items()}, jax.random.key(0))
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), v["params"], new.params)
        sd = convert.state_dict_from_jax({"params": grads, "batch_stats": new.batch_stats}, pspec)
        loss, cm = float(out["loss"]), np.asarray(out["confusion"])
    params = {k for k, _ in pointnet2.PointNet2SemSeg(pspec).named_parameters()}
    return {"loss": loss, "confusion": cm, "grads": {k: v for k, v in sd.items() if k in params},
            "stats": {k: v for k, v in sd.items() if "running_" in k}}


# ------------------------------------------------------------ the train step


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_gradient_equals_the_single_process_gradient(dp, kind):
    _, ranks, _ = dp
    want = _single_step(kind)
    for r in ranks:
        err, name = _worst(r[kind]["grads"], want["grads"])
        assert err <= STEP_TOL, (name, err)
        assert abs(r[kind]["loss"] - want["loss"]) <= STEP_TOL * abs(want["loss"])
        np.testing.assert_array_equal(r[kind]["confusion"], want["confusion"])


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_gradient_equals_the_jax_single_device_train_step(dp, kind):
    _, ranks, _ = dp
    want = _jax_step(kind)
    for r in ranks:
        err, name = _worst(r[kind]["grads"], want["grads"])
        assert err <= STEP_TOL, (name, err)
        assert abs(r[kind]["loss"] - want["loss"]) <= STEP_TOL * abs(want["loss"])
        np.testing.assert_array_equal(r[kind]["confusion"], want["confusion"])


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_batchnorm_statistics_are_the_global_batchs(dp, kind):
    _, ranks, _ = dp
    single, jx = _single_step(kind), _jax_step(kind)
    for r in ranks:
        assert _worst(r[kind]["stats"], single["stats"])[0] <= STEP_TOL
        assert _worst({k: r[kind]["stats"][k] for k in jx["stats"]}, jx["stats"])[0] <= STEP_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_every_rank_applies_the_same_update(dp, kind):
    _, (r0, r1), _ = dp
    for k, v in r0[kind]["params"].items():
        np.testing.assert_array_equal(v, r1[kind]["params"][k], err_msg=k)
    assert _worst(r0[kind]["params"], _single_step(kind)["params"])[0] <= STEP_TOL


@pytest.mark.parametrize("broken", ["no_grad_allreduce", "forward_only_bn", "doubled"])
def test_negative_controls_fail_the_gradient_bound(dp, broken):
    _, ranks, _ = dp
    for want in (_single_step("ssg"), _jax_step("ssg")):
        for r in ranks:
            grads = ({k: 2.0 * g for k, g in r["ssg"]["grads"].items()} if broken == "doubled"
                     else r[broken]["grads"])
            err, _ = _worst(grads, want["grads"])
            assert err > 100 * STEP_TOL, err


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("case", ["all_padding_rank", "unequal_rows"])
def test_masked_batch_norm_across_ranks_is_the_global_batchs(dp, case):
    inputs, ranks, _ = dp
    x, mask, cot, params = inputs["masked_bn"][case]
    bn = torch.nn.BatchNorm1d(x.shape[-1])
    with torch.no_grad():
        for name, value in params.items():
            getattr(bn, name).copy_(value)
    xs = x.clone().requires_grad_(True)
    y = layers.masked_batch_norm(xs, bn, mask)
    (y * cot).sum().backward()
    got = {k: np.concatenate([r["masked_bn"][case][k] for r in ranks]) for k in ("y", "dx")}
    assert _rel(got["y"], y.detach().numpy()) <= BN_TOL
    assert _rel(got["dx"], xs.grad.numpy()) <= BN_TOL
    for r in ranks:
        for k, want in (("mean", bn.running_mean), ("var", bn.running_var), ("dscale", bn.weight.grad),
                        ("dbias", bn.bias.grad)):
            assert _rel(r["masked_bn"][case][k], want.numpy()) <= BN_TOL, k
    # the JAX MaskedBatchNorm without axis_name on the concatenated batch
    p = {k: params[k].numpy() for k in params}
    want, mutated = jlayers.MaskedBatchNorm().apply(
        {"params": {"scale": p["weight"], "bias": p["bias"]},
         "batch_stats": {"mean": p["running_mean"], "var": p["running_var"]}},
        jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()), mutable=["batch_stats"])
    assert _rel(got["y"], np.asarray(want)) <= BN_TOL
    for r in ranks:
        assert _rel(r["masked_bn"][case]["mean"], np.asarray(mutated["batch_stats"]["mean"])) <= BN_TOL
        assert _rel(r["masked_bn"][case]["var"], np.asarray(mutated["batch_stats"]["var"])) <= BN_TOL


def test_wholescene_update_from_two_ranks_equals_the_single_process_update(dp):
    inputs, ranks, _ = dp
    assert [mb["row_mask"].tolist() for mb in inputs["micro_batches"]] == [[1, 1], [1, 0]]
    model = W.port_model(inputs["ssg_spec"], inputs["ssg_state"], torch.float64)
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=0)
    loss_sum = count = 0.0
    for mb in inputs["micro_batches"]:
        batch = {k: torch.from_numpy(v) for k, v in mb.items()}
        res = ts.grad_accum_step(state, {k: v.double() if v.is_floating_point() else v for k, v in batch.items()},
                                 num_classes=CLASSES)
        loss_sum, count = loss_sum + float(res["loss_sum"]), count + float(res["count"])
    ts.apply_accumulated(state, count)
    want_params = {k: p.detach().numpy() for k, p in model.named_parameters()}
    want_stats = {k: b.numpy() for k, b in model.named_buffers() if b.is_floating_point()}
    for r in ranks:
        ws = r["wholescene"]
        assert ws["count"] == count == 3 * N
        assert abs(ws["loss_sum"] - loss_sum) <= STEP_TOL * abs(loss_sum)
        assert _worst(ws["params"], want_params)[0] <= STEP_TOL
        assert _worst(ws["stats"], want_stats)[0] <= STEP_TOL
    for k, v in ranks[0]["wholescene"]["params"].items():
        np.testing.assert_array_equal(v, ranks[1]["wholescene"]["params"][k])


# ----------------------------------------------------------- host and data


def test_allgather_ragged_and_sums_keep_float64(dp):
    _, ranks, _ = dp
    want = np.concatenate([1.0 + np.arange((r + 1) * 3, dtype=np.float64).reshape(r + 1, 3) * 2.0**-40 + r
                           for r in range(W.WORLD)])
    for r in ranks:
        host = r["host"]
        assert host["ragged"].dtype == np.float64
        np.testing.assert_array_equal(host["ragged"], want)
        np.testing.assert_array_equal(host["empty"], want[1:2])  # rank 0 gives no row, rank 1 its first
        np.testing.assert_array_equal(host["sum"], [2.0**41 + 3, 2.0**26 + 6])
        np.testing.assert_array_equal(host["all_rows"], [[0] * 3] * 2 + [[1] * 3] * 2)


def test_merged_scene_results_keep_the_dataset_order(dp):
    """Rank 0 evaluated scenes 0 and 2, rank 1 scene 1 (strided, unequal):
    every rank gets all three back in order, their float64 fields exact."""
    _, ranks, _ = dp
    want = W.scene_results(3)
    for r in ranks:
        ids, rows = r["host"]["merged"]
        assert ids == [s.scene_id for s in want]
        np.testing.assert_array_equal(rows, pack_scene_results(want, CLASSES))


def test_assert_uniform_raises_on_every_rank(dp):
    _, ranks, _ = dp
    for r in ranks:
        assert "steps per epoch differs across ranks" in r["host"]["uniform_error"]
        assert "all=[10, 11]" in r["host"]["uniform_error"]


def test_sharded_loading_and_whole_split_weights_match_jax(dp):
    inputs, ranks, tmp = dp
    ids, root = inputs["scene_ids"], tmp / "scenes"
    whole = jstore.SceneStore.from_npy_dir(ids, root, num_classes=CLASSES)
    for rank, r in enumerate(ranks):
        for equalize in (True, False):
            got_ids, got_w = r["sharded"][equalize]
            want = jstore.SceneStore.from_npy_dir_sharded(ids, root, process_id=rank, num_processes=W.WORLD,
                                                          num_classes=CLASSES, equalize=equalize)
            assert got_ids == want.scene_ids == jstrided_shard(ids, rank, W.WORLD, equalize=equalize)
            np.testing.assert_array_equal(got_w, want.label_weights)
            np.testing.assert_array_equal(got_w, whole.label_weights)  # the whole split's, tail included
    port = SceneStore.from_npy_dir_sharded(ids, root, process_id=1, num_processes=W.WORLD, num_classes=CLASSES)
    np.testing.assert_array_equal(port.label_weights, whole.label_weights)


@pytest.mark.parametrize("equalize", [True, False])
@pytest.mark.parametrize("n,world", [(7, 2), (8, 4), (3, 1), (5, 3)])
def test_strided_shard_and_store_shard_match_jax(n, world, equalize):
    items = [f"s{i}" for i in range(n)]
    scenes = {sid: np.full((4, 11), i % CLASSES, np.float64) for i, sid in enumerate(items)}
    port, jx = SceneStore(items, scenes, num_classes=CLASSES), jstore.SceneStore(items, scenes, num_classes=CLASSES)
    for rank in range(world):
        assert D.strided_shard(items, rank, world, equalize=equalize) == jstrided_shard(
            items, rank, world, equalize=equalize) == D.ProcessContext(rank, world).shard_list(
            items, equalize=equalize)
        got, want = port.shard(rank, world, equalize=equalize), jx.shard(rank, world, equalize=equalize)
        assert got.scene_ids == want.scene_ids and list(got.scenes) == list(want.scenes)
        np.testing.assert_array_equal(got.label_weights, want.label_weights)
    np.testing.assert_array_equal(weights_from_counts(label_counts([scenes[s][:, 10] for s in items], CLASSES)),
                                  jstore.weights_from_counts(jstore.label_counts(
                                      [scenes[s][:, 10] for s in items], CLASSES)))


def test_n_ranks_start_one_kernel_build(dp):
    _, _, tmp = dp
    calls = (tmp / "nvcc_calls.txt").read_text().splitlines()
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    links = [c for c in calls if "-shared" in c]
    assert len(links) == 1, calls
    assert len(calls) == len(build.SOURCES) + 1  # one compile a source, one link
    assert len(list((tmp / "_build").glob("libpn2_kernels_*.so"))) == 1
