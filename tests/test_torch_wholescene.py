"""Whole-scene training in the port against the JAX package, on the CPU.

- MaskedBatchNorm (models/layers.masked_batch_norm) against the JAX module
  in float32, with a full mask and with zero-padded rows: outputs and
  running statistics within 1e-6 relative (both compute the statistics in
  float32 and normalise as ((x - mean) * rsqrt(var + eps)) * scale + bias;
  the reductions add in another order).
- The row-masked train forward of small SSG and MSG models (one padded row)
  against the JAX model's: logits of the real rows and the BatchNorm
  running statistics within the float32 model bound of the port's model
  tests (1e-4).
- One scene's accumulated update (grad_accum_step per micro-batch, then
  apply_accumulated) over a 3-column scene at micro-batch 2, so the second
  micro-batch carries one padded row, in float64, against the JAX package's
  grad_accum_step and apply_accumulated. See UPDATE_TOL for the bounds.
- FPS, the ball queries and 3-NN on a batch whose second row is all zeros,
  as a padded micro-batch row is: indices equal to the JAX ops' and to the
  interpret-mode Pallas kernels'.
- _SceneBatchIterator's micro-batches and set_epoch's tilings bit for bit
  against the JAX package's at epochs 0 and 1, which differ.
- scripts/train_torch.py --use_wholescene on the CPU: runs, reports one
  iter per scene, resumes; a resume refuses --use_wholescene on a chunked
  run, and a whole-scene run resumes as one without the flag.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import config as jconfig
from pointnet2_scannet_tpu.data import synthetic as jsynth
from pointnet2_scannet_tpu.data import wholescene as jwhole
from pointnet2_scannet_tpu.engine import solver as jsolver
from pointnet2_scannet_tpu.engine import train_state as jts
from pointnet2_scannet_tpu.models import layers as jlayers
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.ops import interpolate as jinterp
from pointnet2_scannet_tpu.ops import neighborhood as jnb
from pointnet2_scannet_tpu.ops import sampling as jsamp
from pointnet2_scannet_tpu.ops.pallas.ball_query_kernel import ball_query_multi_pallas, ball_query_pallas
from pointnet2_scannet_tpu.ops.pallas.fps_kernel import furthest_point_sample_pallas
from pointnet2_scannet_tpu.ops.pallas.three_nn_kernel import three_nn_pallas_t
from pointnet2_scannet_tpu_torch import config, ops
from pointnet2_scannet_tpu_torch.data import synthetic, wholescene
from pointnet2_scannet_tpu_torch.engine import checkpoint, solver
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.models import convert, layers, pointnet2
from tests.test_torch_msg_port import SMALL_MSG
from tests.test_torch_port_model import SMALL, _randomize_bn
from tests.test_torch_train_step import _x64

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPECS = {"ssg": SMALL, "msg": SMALL_MSG}
N = 256
LR = 1e-3
# one scene's update in float64. The JAX MaskedBatchNorm computes its
# statistics and normalises in float32 whatever the input's dtype (the port
# keeps float64), and both models cast their logits to float32, so a float64
# update agrees only to float32 (measured: loss sums 8.3e-8 relative, running
# statistics 8.0e-7 and the median parameter 3.0e-8 in per-tensor relative
# L2). Adam's first step
# moves each weight by lr * g / (|g| + 1e-8): where a gradient is of the
# order of that eps, as the last BatchNorm bias of an SA level's MLP is here,
# float32 noise moves the step anywhere in [-lr, lr] (measured: 4.1e-3
# relative L2, 1.1e-3 absolute). Bounds: loss sums rtol; per-tensor relative
# L2 of the running statistics, of the median parameter and of the worst
# parameter (the float32 trajectory test's); elementwise, two steps' moves.
UPDATE_TOL = dict(loss=5e-7, stats=1e-5, l2_median=1e-7, l2=5e-2, atol=2 * LR)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# ------------------------------------------------------- MaskedBatchNorm


@pytest.mark.parametrize(
    "shape,real", [((4, 64, 16), 4), ((8, 32, 8), 3), ((6, 16, 8, 12), 5)],
    ids=["full-mask", "padded", "padded-4d"],
)
def test_masked_batch_norm_matches_the_jax_module(shape, real):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.7, 1.3, size=shape).astype(np.float32)
    x[real:] = 0.0
    mask = (np.arange(shape[0]) < real).astype(np.float32)
    c = shape[-1]
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    want, mutated = jlayers.MaskedBatchNorm().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(mask),
        mutable=["batch_stats"],
    )

    def port(xs, m):
        bn = torch.nn.BatchNorm1d(c)
        with torch.no_grad():
            for name, value in (("weight", params["scale"]), ("bias", params["bias"]),
                                ("running_mean", stats["mean"]), ("running_var", stats["var"])):
                getattr(bn, name).copy_(torch.from_numpy(value))
        y = layers.masked_batch_norm(torch.from_numpy(xs), bn, torch.from_numpy(m))
        return y.detach().numpy(), bn.running_mean.numpy(), bn.running_var.numpy()

    got, mean, var = port(x, mask)
    assert got.dtype == np.float32 and got.shape == shape
    assert _rel(got, np.asarray(want)) <= 1e-6
    assert _rel(mean, np.asarray(mutated["batch_stats"]["mean"])) <= 1e-6
    assert _rel(var, np.asarray(mutated["batch_stats"]["var"])) <= 1e-6
    # the padded rows leave the statistics as the ragged batch of real rows
    ragged, r_mean, r_var = port(x[:real].copy(), np.ones(real, np.float32))
    assert _rel(got[:real], ragged) <= 1e-6 and _rel(mean, r_mean) <= 1e-6 and _rel(var, r_var) <= 1e-6


# --------------------------------------------------- row-masked model


def _models(kind, dtype, seed):
    """A JAX model with random BatchNorm and the port's model over the same
    weights, Dropout off."""
    spec_kwargs = dict(SPECS[kind], dropout=0.0)
    jm = jmodel.PointNet2SemSeg(spec=jmodel.PointNet2Spec(**spec_kwargs))
    pspec = pointnet2.PointNet2Spec(**spec_kwargs)
    pc = np.zeros((2, N, 3 + pspec.input_channels), np.float32)
    variables = _randomize_bn(jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(seed), pc), seed)
    model = pointnet2.PointNet2SemSeg(pspec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(variables, pspec).items()})
    return jm, variables, model.to(getattr(torch, dtype)), pspec


def _scene(columns, channels, num_classes, seed, dtype="float32"):
    """A scene's column stack (S, N, 3 + C), labels and weights; numpy."""
    rng = np.random.default_rng(seed)
    pc = np.concatenate([rng.uniform(0, 1.5, (columns, N, 3)), rng.normal(0, 0.5, (columns, N, channels))], -1)
    labels = rng.integers(0, num_classes, (columns, N)).astype(np.int32)
    weights = 1.0 / np.log(1.2 + rng.dirichlet(np.ones(num_classes)))[labels]
    return pc.astype(dtype), labels, weights.astype(dtype)


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_row_masked_train_forward_matches_jax(kind):
    jm, variables, model, pspec = _models(kind, "float32", seed=4)
    pc, _, _ = _scene(3, pspec.input_channels, pspec.num_classes, seed=5)
    pc[2] = 0.0  # the padded row of a last micro-batch
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    want, mutated = jax.jit(lambda v, x, m: jm.apply(v, x, train=True, row_mask=m, mutable=["batch_stats"]))(
        variables, jnp.asarray(pc), jnp.asarray(mask))
    model.train()
    got = model(torch.from_numpy(pc), None, torch.from_numpy(mask)).detach().numpy()
    assert np.isfinite(got).all() and np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got[:2], np.asarray(want)[:2], rtol=1e-4, atol=1e-4)
    stats = convert.state_dict_from_jax({"params": variables["params"], "batch_stats": mutated["batch_stats"]}, pspec)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k], rtol=1e-4, atol=1e-4, err_msg=k)
    # no mask: the train forward keeps flax's BatchNorm (the chunked step)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(variables, pspec).items()})
    unmasked = model(torch.from_numpy(pc[:2].copy())).detach().numpy()
    want2 = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])(variables, jnp.asarray(pc[:2]))
    np.testing.assert_allclose(unmasked, np.asarray(want2), rtol=1e-4, atol=1e-4)


# ----------------------------------------- one scene's accumulated update


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_accumulated_scene_update_matches_jax_in_float64(kind):
    jm, variables, model, pspec = _models(kind, "float64", seed=6)
    feats, labels, weights = _scene(3, pspec.input_channels, pspec.num_classes, seed=7, dtype="float64")
    micro = list(solver._SceneBatchIterator(None, 2).micro_batches(feats, labels, weights))
    assert [mb["row_mask"].tolist() for mb in micro] == [[1.0, 1.0], [1.0, 0.0]]

    schedule = ts.make_lr_schedule(LR, 1, 0.7, 1)
    state = ts.create_train_state(model, schedule, seed=0)
    p_out = [ts.grad_accum_step(state, {k: torch.from_numpy(v) for k, v in mb.items()},
                                num_classes=pspec.num_classes) for mb in micro]
    count = p_out[0]["count"] + p_out[1]["count"]
    ts.apply_accumulated(state, count)
    assert state.step == 1 and all(p.grad is None for p in model.parameters())
    assert state.optimizer.param_groups[0]["lr"] == LR

    with _x64(True):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        jstate = jts.TrainState.create(apply_fn=jm.apply, params=jvars["params"], batch_stats=jvars["batch_stats"],
                                       tx=jts.make_optimizer(jts.make_lr_schedule(LR, 1, 0.7, 1)))
        step = jax.jit(lambda s, b, i: jts.grad_accum_step(s, b, jax.random.key(0), i, num_classes=pspec.num_classes))
        j_out, grads_sum, count_sum = [], None, None
        for i, mb in enumerate(micro):
            grads, bs, ls, cnt, cm = step(jstate, {k: jnp.asarray(v) for k, v in mb.items()}, i)
            jstate = jstate.replace(batch_stats=bs)
            j_out.append((float(ls), float(cnt), np.asarray(cm)))
            grads_sum = grads if grads_sum is None else jax.tree_util.tree_map(lambda a, b: a + b, grads_sum, grads)
            count_sum = cnt if count_sum is None else count_sum + cnt
        jstate = jts.apply_accumulated(jstate, grads_sum, count_sum)
        final = {k: np.asarray(v, np.float64) for k, v in convert.state_dict_from_jax(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}, pspec).items()}

    tol = UPDATE_TOL
    for p, (ls, cnt, cm) in zip(p_out, j_out):
        np.testing.assert_allclose(float(p["loss_sum"]), ls, rtol=tol["loss"])
        assert float(p["count"]) == cnt
        np.testing.assert_array_equal(p["confusion"].numpy(), cm)
    assert [float(p["count"]) for p in p_out] == [2 * N, N]
    errors = []
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got = v.detach().double().numpy()
        err = np.linalg.norm(got - final[k]) / np.linalg.norm(final[k])
        if "running" in k:
            assert err <= tol["stats"], (k, err)
            continue
        errors.append(err)
        assert err <= tol["l2"], (k, err)
        np.testing.assert_allclose(got, final[k], rtol=0, atol=tol["atol"], err_msg=k)
    assert np.median(errors) <= tol["l2_median"]


# ------------------------------------------------- kernels on a zero row


def test_sampling_and_queries_on_an_all_zero_row_match_jax():
    rng = np.random.default_rng(8)
    xyz = np.stack([rng.uniform(0, 1.5, (N, 3)), np.zeros((N, 3))]).astype(np.float32)
    jx = jnp.asarray(xyz)
    idx = ops.furthest_point_sample(torch.from_numpy(xyz), 64).numpy()
    np.testing.assert_array_equal(idx, np.asarray(jsamp.furthest_point_sample(jx, 64, use_pallas=False)))
    np.testing.assert_array_equal(idx, np.asarray(furthest_point_sample_pallas(jx, 64, interpret=True)))
    assert (idx[1] == 0).all()  # every point sits at the origin: FPS keeps index 0
    q = np.take_along_axis(xyz, idx[..., None].astype(np.int64), axis=1)
    jq = jnp.asarray(q)
    got = ops.ball_query(0.3, 8, torch.from_numpy(xyz), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnb.ball_query(0.3, 8, jx, jq, use_pallas=False)))
    np.testing.assert_array_equal(got, np.asarray(ball_query_pallas(0.3, 8, jx, jq, interpret=True)))
    assert (got[1] == np.arange(8)).all()  # every point lies inside: the first 8 in order
    got2 = ops.ball_query_multi((0.2, 0.4), (8, 16), torch.from_numpy(xyz), torch.from_numpy(q))
    want2 = ball_query_multi_pallas((0.2, 0.4), (8, 16), jx, jq, interpret=True)
    for g, w in zip(got2, want2, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d2, nn = ops.three_nn(torch.from_numpy(xyz), torch.from_numpy(q))
    for jd2, jidx in (jinterp.three_nn(jx, jq, use_pallas=False), three_nn_pallas_t(jx, jq, interpret=True)):
        np.testing.assert_array_equal(nn.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(d2[1].numpy(), np.asarray(jd2)[1])
    assert (nn[1].numpy() == [0, 1, 2]).all() and not d2[1].any()


# -------------------------------------------- micro-batches and epochs


def test_scene_micro_batches_and_epoch_tilings_match_jax():
    kw = dict(npoints=512, use_color=True, use_normal=True)
    jds = jwhole.WholeSceneDataset(jsynth.make_synthetic_store(2, seed=1000), jconfig.DataConfig(**kw), seed=3)
    pds = wholescene.WholeSceneDataset(synthetic.make_synthetic_store(2, seed=1000), config.DataConfig(**kw), seed=3)
    first = {}
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        scenes = zip(jsolver._SceneBatchIterator(jds, 8).scenes(),
                     solver._SceneBatchIterator(pds, 8).scenes(), strict=True)
        for (jsid, jmbs), (psid, pmbs) in scenes:
            assert jsid == psid
            pmbs = list(pmbs)
            for jmb, pmb in zip(jmbs, pmbs, strict=True):
                assert jmb.keys() == pmb.keys()
                for k in jmb:
                    assert jmb[k].dtype == pmb[k].dtype and jmb[k].shape[0] == 8
                    np.testing.assert_array_equal(pmb[k], jmb[k])
            real = sum(int(mb["row_mask"].sum()) for mb in pmbs)
            assert real == len(pds.get_scene(pds.store.scene_ids.index(psid))[0]) > 8
            assert pmbs[-1]["row_mask"][-1] == 0.0 or real % 8 == 0
        first[epoch] = pds.get_scene(0)[0]
    assert first[0].shape == first[1].shape and not np.array_equal(first[0], first[1])


# ------------------------------------------------------------ the CLI

BASE = ["--device", "cpu", "--synthetic", "--synthetic_scenes", "1", "--npoints", "256",
        "--batch_size", "16", "--verbose", "1", "--use_color", "--use_normal"]


def _train(argv):
    spec = importlib.util.spec_from_file_location("train_torch", ROOT / "scripts" / "train_torch.py")
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run, best = train_torch.train(train_torch.parse_args(argv))
    return run, best, out.getvalue()


def _copy(run_dir, tmp_path):
    copy = tmp_path / run_dir.name
    for f in run_dir.rglob("*"):
        if f.is_file():
            (copy / f.relative_to(run_dir)).parent.mkdir(parents=True, exist_ok=True)
            (copy / f.relative_to(run_dir)).write_bytes(f.read_bytes())
    return copy


@pytest.fixture(scope="module")
def wholescene_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("wholescene")
    return _train([*BASE, "--use_wholescene", "--epoch", "1", "--tag", "ws", "--output_root", str(root)])


def test_train_torch_wholescene_runs_and_resumes(wholescene_run, tmp_path):
    run_dir, best, log = wholescene_run
    assert "1 steps per epoch, one update per scene" in log
    iters = re.findall(r"^epoch \[1/1\] iter \[1/1\] loss (\S+) point_acc", log, re.M)
    assert len(iters) == 1 and np.isfinite(float(iters[0]))
    assert re.search(r"^epoch \[1/1\] done: train loss \S+ val loss \S+", log, re.M)
    for name in ("config.json", "best.txt", "model_best.pt", "model_last.pt", "model_last.train.pt",
                 "tensorboard/all_scalars.json"):
        assert (run_dir / name).is_file(), name
    assert json.loads((run_dir / "config.json").read_text())["train"]["wholescene"] is True
    assert torch.load(run_dir / "model_last.train.pt", weights_only=True)["step"] == 1  # one scene
    # resumed without the flag: the run's mode comes from its config.json
    copy = _copy(run_dir, tmp_path)
    before = checkpoint.load_state_dict(copy, "model_last")
    _, _, log = _train(["--device", "cpu", "--resume", str(copy), "--epoch", "2"])
    assert "(from epoch 1)" in log and "one update per scene" in log
    assert re.findall(r"^epoch \[(\d)/2\] iter \[1/1\]", log, re.M) == ["2"]
    assert torch.load(copy / "model_last.train.pt", weights_only=True)["step"] == 2
    after = checkpoint.load_state_dict(copy, "model_last")
    assert any(not torch.equal(before[k], after[k]) for k in before)


def test_resume_refuses_wholescene_on_a_chunked_run(tmp_path):
    run_dir, _, _ = _train([*BASE, "--synthetic_scenes", "4", "--batch_size", "4", "--epoch", "0",
                            "--output_root", str(tmp_path)])
    assert json.loads((run_dir / "config.json").read_text())["train"]["wholescene"] is False
    with pytest.raises(SystemExit, match="--use_wholescene passed but the resumed run was not"):
        _train(["--device", "cpu", "--resume", str(run_dir), "--use_wholescene", "--epoch", "1"])
