"""The port's whole-scene evaluator and its eval/visualize CLIs, on the CPU,
against the JAX package.

- Indexed tiling: WholeSceneDataset.max_points, estimate_columns and
  get_scene_indexed equal the JAX dataset's bit for bit, and
  feats_all[col_idx] equals get_scene's stack; compute_acc and compute_miou
  equal the JAX functions.
- The evaluator pipeline against the JAX evaluator: an oracle stub on each
  side returns one-hot logits of the label planted in feature channel 3 (the
  first normal channel, which both packages pass through unchanged), over
  scenes of three sizes, at several batch, ring and depth settings. Every
  SceneResult and EvalReport field and the format_table() string are equal.
- The JAX evaluator's own cases with torch stubs (the padded last batch, the
  masked average, pipelined against sequential with batches that straddle
  scenes, slot eviction, varying scene sizes, a custom ring and depth, the
  auto-sized ring, the progress callback, an empty dataset, the pred dtype,
  the pack/unpack round trip), and a stress run of many tiny scenes with a
  short thread switch interval.
- Real weights: a JAX-initialised SSG run dir converted by
  scripts/jax_to_torch.py, evaluated by scripts/eval_torch.py --device cpu
  and by the JAX evaluator on one synthetic scene. At least 99.9% of the
  points get the same label. Each accuracy may differ by at most the share
  of its points (or voxels) whose label differs, each class's IoU by at most
  2 n / T_c: n differing points (voxels) move the class's intersection and
  union by at most n each, and its union holds at least its T_c targets.
- The CLI chain on the CPU: train_torch.py, then eval_torch.py writes
  eval_report.txt and visualize_torch.py one PLY a scene; the item-12 flags
  and --device cuda without a card raise; a bfloat16 run dir evaluates and
  visualises (its model built in bfloat16).
"""

import dataclasses
import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.config import DataConfig as JDataConfig
from pointnet2_scannet_tpu.data import synthetic as jsynth
from pointnet2_scannet_tpu.data import wholescene as jwhole
from pointnet2_scannet_tpu.data.scene_store import SceneStore as JSceneStore
from pointnet2_scannet_tpu.engine import evaluator as jeval
from pointnet2_scannet_tpu.engine import metrics as jmetrics
from pointnet2_scannet_tpu_torch.config import DataConfig
from pointnet2_scannet_tpu_torch.data import SceneStore, WholeSceneDataset, make_synthetic_scene, make_synthetic_store
from pointnet2_scannet_tpu_torch.engine import evaluator as peval
from pointnet2_scannet_tpu_torch.engine import metrics as pmetrics
from tests.test_torch_port_slice import _jax_run

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Oracle(torch.nn.Module):
    """One-hot logits of the label planted in feature channel 3."""

    def forward(self, pc):
        return torch.nn.functional.one_hot(pc[..., 3].to(torch.int64), 20).float() * 10.0


def jax_oracle(variables, pc, train=False):
    return jnp.eye(20)[pc[..., 3].astype(jnp.int32)] * 10.0


class CoordHash(torch.nn.Module):
    """Logits from the coordinates alone, so every path over the same
    columns must give the same labels."""

    def forward(self, pc):
        h = (pc[..., :3] * torch.tensor([7.1, 3.3, 1.7])).sum(-1)
        return torch.nn.functional.one_hot((h.abs() * 100.0).to(torch.int64) % 20, 20).float() * 5.0


def _planted_scenes():
    """Three synthetic scenes of 9000, 4000 and 2500 points whose first
    normal channel holds each point's label."""
    scenes = {
        "a_full_00": make_synthetic_scene(0, n_points=9_000),
        "b_small_00": make_synthetic_scene(1, n_points=9_000)[:4_000],
        "c_tiny_00": make_synthetic_scene(2, n_points=9_000)[:2_500],
    }
    for s in scenes.values():
        s[:, 6] = s[:, 10]
    return scenes


def _datasets(scenes, npoints=128, use_color=False, use_normal=True):
    port = WholeSceneDataset(SceneStore.from_scenes({k: v.copy() for k, v in scenes.items()}),
                             DataConfig(npoints=npoints, use_color=use_color, use_normal=use_normal), seed=0)
    ref = jwhole.WholeSceneDataset(JSceneStore.from_scenes({k: v.copy() for k, v in scenes.items()}),
                                   JDataConfig(npoints=npoints, use_color=use_color, use_normal=use_normal), seed=0)
    return port, ref


def _assert_results_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        if f.name == "scenes":
            assert len(got.scenes) == len(want.scenes)
            for a, b in zip(got.scenes, want.scenes):
                _assert_results_equal(a, b)
        else:
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)


def _sequential(ev, ds):
    return ev.aggregate([ev.eval_scene(sid, f, l, w) for sid, (f, l, w) in ds.iter_scenes()])


def _hash_dataset(n_scenes, n_points, npoints):
    return WholeSceneDataset(make_synthetic_store(n_scenes, n_points=n_points),
                             DataConfig(npoints=npoints, use_color=True), seed=0)


# ------------------------------------------------------- data and metrics


@pytest.mark.parametrize("use_color,use_normal", [(True, True), (False, False)])
def test_indexed_tiling_equals_jax(use_color, use_normal):
    port, ref = _datasets(_planted_scenes(), npoints=256, use_color=use_color, use_normal=use_normal)
    assert port.input_channels == ref.input_channels
    assert port.max_points() == ref.max_points() == 9_000
    assert port.estimate_columns() == ref.estimate_columns()
    for i in range(len(port)):
        got, want = port.get_scene_indexed(i), ref.get_scene_indexed(i)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        feats_all, col_idx = got[:2]
        np.testing.assert_array_equal(feats_all[col_idx], port.get_scene(i)[0])
    assert [s for s, _ in port.iter_scenes_indexed()] == port.store.scene_ids


def test_compute_acc_and_miou_equal_jax():
    rng = np.random.default_rng(3)
    coords = np.round(rng.uniform(0, 1, (4000, 3)), 2).astype(np.float32)  # duplicates
    targets = rng.integers(0, 20, 4000)
    preds = np.where(rng.uniform(size=4000) < 0.6, targets, rng.integers(0, 20, 4000))
    weights = np.ones(4000, np.float32)
    for port_fn, jax_fn in ((pmetrics.compute_acc, jmetrics.compute_acc),
                            (pmetrics.compute_miou, jmetrics.compute_miou)):
        for a, b in zip(port_fn(coords, preds, targets, weights), jax_fn(coords, preds, targets, weights)):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------- the pipeline against JAX


@pytest.mark.parametrize("batch,ring,depth", [(4, None, 2), (16, 2, 1), (3, 3, 3)])
def test_oracle_report_equals_the_jax_evaluator(batch, ring, depth):
    port, ref = _datasets(_planted_scenes())
    got_ev = peval.WholeSceneEvaluator(Oracle(), device="cpu", batch_size=batch, ring_slots=ring,
                                       queue_depth=depth)
    want_ev = jeval.WholeSceneEvaluator(jax_oracle, {}, batch_size=batch, ring_slots=ring, queue_depth=depth)
    got, want = got_ev.evaluate(port, verbose=False), want_ev.evaluate(ref, verbose=False)
    _assert_results_equal(got, want)
    assert got.format_table() == want.format_table()
    assert got_ev.last_ring_slots == want_ev.last_ring_slots
    assert got.point_acc == 1.0  # the oracle is right everywhere


def test_auto_ring_sizing_equals_jax():
    port, ref = _datasets({f"s{i:02d}": make_synthetic_scene(i, n_points=2_000) for i in range(10)})
    got_ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=16)
    want_ev = jeval.WholeSceneEvaluator(jax_oracle, {}, batch_size=16)
    for args in ((2000, 6, 16, 2, 0), (2000, 6, 16, 2, 128 * 4 * 8), (10**7, 9, 32, 3, 10**8)):
        assert got_ev._pick_ring(port, *args) == want_ev._pick_ring(ref, *args)
    report = got_ev.evaluate(port, verbose=False)
    assert got_ev.last_ring_slots > 4  # grew beyond the floor: tiny scenes
    _assert_results_equal(report, _sequential(got_ev, port))


# ------------------------------------------------ the JAX evaluator's cases


def _planted_columns():
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 3, size=(5, 512, 4)).astype(np.float32)
    labels = rng.integers(0, 20, size=(5, 512)).astype(np.int32)
    feats[..., 3] = labels
    return feats, labels, np.ones((5, 512), np.float32)


def test_perfect_model_scores_one_and_pads_the_last_batch():
    feats, labels, weights = _planted_columns()
    ev = peval.WholeSceneEvaluator(Oracle(), device="cpu", batch_size=2)  # 5 columns: the last batch padded
    preds = ev.predict_scene(feats)
    assert preds.shape == (5, 512) and preds.dtype == np.int64
    np.testing.assert_array_equal(preds, labels)
    r = ev.eval_scene("s", feats, labels, weights)
    assert r.point_acc == 1.0
    np.testing.assert_allclose(r.point_acc_per_class[r.acc_mask.astype(bool)], 1.0)
    np.testing.assert_allclose(r.voxel_miou[r.miou_mask.astype(bool)], 1.0)


def test_aggregate_masked_average():
    feats, labels, weights = _planted_columns()
    ev = peval.WholeSceneEvaluator(Oracle(), device="cpu", batch_size=4)
    f2 = feats.copy()
    f2[..., 3] = 0
    r1, r2 = ev.eval_scene("a", feats, labels, weights), ev.eval_scene("b", f2, np.zeros_like(labels), weights)
    report = ev.aggregate([r1, r2])
    want = jeval.WholeSceneEvaluator(jax_oracle, {}, batch_size=4).aggregate([r1, r2])
    _assert_results_equal(report, want)
    assert report.point_acc == 1.0 and report.per_class_point_acc[0] == pytest.approx(1.0)


def test_pred_dtype_tracks_num_classes():
    feats = _planted_columns()[0]
    ev8 = peval.WholeSceneEvaluator(Oracle(), device="cpu", batch_size=2)
    ev32 = peval.WholeSceneEvaluator(Oracle(), device="cpu", batch_size=2, num_classes=200)
    assert (ev8._pred_dtype, ev32._pred_dtype) == (torch.int8, torch.int32)
    np.testing.assert_array_equal(ev8.predict_scene(feats), ev32.predict_scene(feats))


@pytest.mark.parametrize("n_scenes,n_points,npoints,batch,ring", [
    (3, 12_000, 256, 4, None),  # batches straddle scenes
    (10, 2_000, 128, 16, 2),  # a batch spans more scenes than the ring holds: flushes
])
def test_pipelined_equals_sequential(n_scenes, n_points, npoints, batch, ring):
    ds = _hash_dataset(n_scenes, n_points, npoints)
    ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=batch, ring_slots=ring)
    report = ev.evaluate(ds, verbose=False)
    assert [r.scene_id for r in report.scenes] == ds.store.scene_ids
    _assert_results_equal(report, _sequential(ev, ds))
    assert [t["scene_id"] for t in ev.last_timings] == ds.store.scene_ids
    assert all(t["tile_ms"] > 0 and t["forward_ms"] > 0 and t["metrics_ms"] > 0 for t in ev.last_timings)


def test_varying_scene_sizes_pad_the_ring():
    ds = WholeSceneDataset(SceneStore.from_scenes(_planted_scenes()), DataConfig(npoints=128, use_color=True))
    ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=8)
    _assert_results_equal(ev.evaluate(ds, verbose=False), _sequential(ev, ds))


def test_custom_ring_and_depth_match_default():
    ds = _hash_dataset(6, 2_000, 128)
    base = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=8, ring_slots=4).evaluate(ds, verbose=False)
    for ring, depth in ((2, 1), (6, 3), (1, 1)):
        ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=8, ring_slots=ring, queue_depth=depth)
        _assert_results_equal(ev.evaluate(ds, verbose=False), base)


def test_many_tiny_scenes_under_fast_thread_switching():
    ds = _hash_dataset(24, 600, 64)
    ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=5, ring_slots=2, queue_depth=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = ev.map_scenes(ds, lambda sid, c, l, w, p: (sid, p))
    finally:
        sys.setswitchinterval(interval)
    assert [sid for sid, _ in got] == ds.store.scene_ids
    for (sid, p), (_, (f, _, _)) in zip(got, ds.iter_scenes()):
        np.testing.assert_array_equal(p, ev.predict_scene(f))


def test_map_scenes_progress_and_scene_fn_inputs():
    ds = _hash_dataset(2, 5_000, 128)
    ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=4)
    seen = []
    got = ev.map_scenes(ds, lambda sid, c, l, w, p: (sid, c.shape, p.shape, p.dtype), progress=seen.append)
    assert [g[0] for g in got] == ds.store.scene_ids and seen == got
    for _, cshape, pshape, pdtype in got:
        assert cshape == pshape + (3,) and cshape[1] == 128 and pdtype == np.int64


def test_empty_dataset_returns_empty():
    ds = WholeSceneDataset(SceneStore([], {}), DataConfig(npoints=128))
    ev = peval.WholeSceneEvaluator(CoordHash(), device="cpu", batch_size=4)
    assert ev.map_scenes(ds, lambda *a: a) == []


def test_pack_unpack_round_trip():
    port, ref = _datasets(_planted_scenes())
    results = peval.WholeSceneEvaluator(Oracle(), device="cpu", batch_size=8).evaluate(port, verbose=False).scenes
    rows = peval.pack_scene_results(results)
    np.testing.assert_array_equal(rows, jeval.pack_scene_results(results))
    back = peval.unpack_scene_results(rows, [r.scene_id for r in results])
    for a, b in zip(back, results):
        _assert_results_equal(a, b)
    assert peval.unpack_scene_results(rows)[1].scene_id == "scene0001"


# --------------------------------------------------------- real weights


def _scene_outputs(ev, ds):
    """(SceneResult, coords, labels, weights, preds) per scene."""
    return ev.map_scenes(ds, lambda sid, c, l, w, p: (ev._metrics_for(sid, c, l, w, p), c, l, w, p))


def test_eval_torch_agrees_with_the_jax_evaluator_on_converted_weights(tmp_path):
    npoints = 2048
    run, cfg, model, variables = _jax_run(tmp_path / "run", False, npoints)
    eval_torch = _script("eval_torch")
    args = eval_torch.parse_args(["--folder", str(run), "--device", "cpu", "--synthetic",
                                  "--synthetic_scenes", "1", "--batch_size", "8"])
    got = eval_torch.evaluate(args)
    assert (run / "eval_report.txt").read_text() == got.format_table()
    _, port_ds, port_ev = eval_torch.load(args)
    [(port_scene, coords, labels, weights, port_preds)] = _scene_outputs(port_ev, port_ds)
    _assert_results_equal(port_scene, got.scenes[0])  # the CLI's run and this one: the same bits

    ref_ds = jwhole.WholeSceneDataset(jsynth.make_synthetic_store(1, seed=1000), cfg.data, seed=0)
    ref_ev = jeval.WholeSceneEvaluator(model.apply, variables, batch_size=8)
    [(ref_scene, _, _, _, ref_preds)] = _scene_outputs(ref_ev, ref_ds)
    want = ref_ev.aggregate([ref_scene])
    assert np.mean(port_preds == ref_preds) >= 0.999

    # the metrics' points and voxels, with each side's labels
    flat = coords.reshape(-1, 3), labels.reshape(-1).astype(np.int64), weights.reshape(-1)
    p_pts, targets, seen, p_vox = pmetrics._dedup_and_voxelize(flat[0], port_preds.reshape(-1), flat[1], flat[2], 20)
    r_pts, _, _, r_vox = pmetrics._dedup_and_voxelize(flat[0], ref_preds.reshape(-1), flat[1], flat[2], 20)
    n_pts, n_vox = int(np.sum(p_pts != r_pts)), int(np.sum(p_vox[:, 1] != r_vox[:, 1]))
    pt_count = np.maximum(np.bincount(targets, minlength=20), 1)
    vox_count = np.maximum(np.bincount(p_vox[:, 0], minlength=20), 1)
    assert abs(got.point_acc - want.point_acc) <= n_pts / len(targets)
    assert abs(got.voxel_acc - want.voxel_acc) <= n_vox / len(p_vox)
    pt_bound, vox_bound = 2 * n_pts / pt_count, 2 * n_vox / vox_count
    assert np.all(np.abs(got.per_class_point_miou - want.per_class_point_miou) <= pt_bound)
    assert np.all(np.abs(got.per_class_voxel_miou - want.per_class_voxel_miou) <= vox_bound)
    assert abs(got.point_miou - want.point_miou) <= pt_bound[seen].mean()
    assert abs(got.voxel_miou - want.voxel_miou) <= vox_bound[seen].mean()


# --------------------------------------------------------------- the CLIs


def test_train_eval_visualize_chain(tmp_path):
    _script("train_torch").train(_script("train_torch").parse_args([
        "--device", "cpu", "--synthetic", "--synthetic_scenes", "4", "--npoints", "256", "--batch_size", "4",
        "--epoch", "1", "--verbose", "1", "--use_color", "--use_normal", "--output_root", str(tmp_path / "runs"),
    ]))
    [run] = list((tmp_path / "runs").iterdir())
    common = ["--folder", str(run), "--device", "cpu", "--synthetic", "--synthetic_scenes", "2", "--batch_size", "8"]
    eval_torch = _script("eval_torch")
    report = eval_torch.evaluate(eval_torch.parse_args(common))
    assert len(report.scenes) == 2
    assert (run / "eval_report.txt").read_text() == report.format_table()
    values = [report.point_acc, report.voxel_acc, report.voxel_cali_acc, report.point_miou, report.voxel_miou]
    assert all(0.0 <= v <= 1.0 for v in values)
    visualize_torch = _script("visualize_torch")
    written = visualize_torch.visualize(visualize_torch.parse_args(common))
    plys = sorted((run / "preds").glob("*.ply"))
    assert [p.name for p in plys] == ["synth0000_00.ply", "synth0001_00.ply"] == [w[0].name for w in written]
    for ply, (_, n) in zip(plys, written):
        lines = ply.read_text().splitlines()
        assert f"element vertex {n}" in lines and len(lines) == lines.index("end_header") + 1 + n


@pytest.mark.parametrize("script", ["eval_torch", "visualize_torch"])
@pytest.mark.parametrize("flag", [["--num_devices", "64", "--device", "cuda"],
                                  ["--dist_coordinator", "localhost:1234", "--num_devices", "2"],
                                  ["--dist_nprocs", "2", "--num_devices", "2"],
                                  ["--dist_pid", "1", "--num_devices", "2"], ["--dist_auto", "--num_devices", "2"]])
def test_data_parallel_and_multi_host_flags_raise(tmp_path, script, flag):
    # data-parallel evaluation is ported (tests/test_torch_parallel_cli.py);
    # what it refuses: more ranks than cards, --num_devices beside --dist_*
    mod = _script(script)
    entry = mod.evaluate if script == "eval_torch" else mod.visualize
    with pytest.raises(ValueError, match="ranks on this host but only|cannot be combined with --dist_"):
        entry(mod.parse_args(["--folder", str(tmp_path), "--device", "cpu", "--synthetic", *flag]))


@pytest.mark.parametrize("script", ["eval_torch", "visualize_torch"])
def test_cuda_default_fails_without_a_card(tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = _script(script)
    args = mod.parse_args(["--folder", str(tmp_path), "--synthetic"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (mod.evaluate if script == "eval_torch" else mod.visualize)(args)


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """A run dir that train_torch.py --bf16 wrote (SSG, 256-point columns)."""
    root = tmp_path_factory.mktemp("bf16_runs")
    _script("train_torch").train(_script("train_torch").parse_args([
        "--device", "cpu", "--synthetic", "--synthetic_scenes", "4", "--npoints", "256", "--batch_size", "4",
        "--epoch", "1", "--verbose", "1", "--use_color", "--use_normal", "--bf16", "--output_root", str(root),
    ]))
    [run] = list(root.iterdir())
    return run


@pytest.mark.parametrize("script", ["eval_torch", "visualize_torch"])
def test_bf16_run_dir_evaluates_and_visualizes(bf16_run, script):
    from pointnet2_scannet_tpu_torch.engine.export import load_run_model

    model, cfg = load_run_model(bf16_run)
    assert cfg.model.compute_dtype == "bfloat16" and model.dtype == torch.bfloat16
    mod = _script(script)
    args = mod.parse_args(["--folder", str(bf16_run), "--device", "cpu", "--synthetic", "--synthetic_scenes", "1",
                           "--batch_size", "8"])
    if script == "eval_torch":
        report = mod.evaluate(args)
        assert len(report.scenes) == 1 and 0.0 <= report.point_acc <= 1.0
        assert (bf16_run / "eval_report.txt").read_text() == report.format_table()
    else:
        [(ply, n)] = mod.visualize(args)
        assert ply.is_file() and f"element vertex {n}" in ply.read_text().splitlines()
