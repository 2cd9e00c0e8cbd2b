"""Solver(compute_voxel_metrics=False) against the JAX Solver's.

The JAX Solver (engine/solver.py:105) takes compute_voxel_metrics; with
False its validation skips the voxel metrics of each batch (chunked) or
scene (whole scenes), its val stats hold the loss, the point metrics and
voxel_miou set to the point mIoU (_finish_voxel_stats, :849-851, and
:1065-1070), and model_best therefore gates on point mIoU. The port's
chunked Solver and WholeSceneSolver, on a small model over synthetic
scenes on the CPU, against those stats keys (the JAX Solver's own
_finish_voxel_stats on the same point metrics) and that gating.
"""

import types

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.engine import metrics as jmetrics
from pointnet2_scannet_tpu.engine import solver as jsolver
from pointnet2_scannet_tpu_torch import config
from pointnet2_scannet_tpu_torch.data import chunks, synthetic
from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset
from pointnet2_scannet_tpu_torch.engine.solver import Solver, WholeSceneSolver
from pointnet2_scannet_tpu_torch.models import pointnet2
from tests.test_torch_resident import DATA, SPEC


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small shapes gain nothing from more, which
    would only contend with the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_stat_keys(cm: np.ndarray, compute_voxel_metrics: bool) -> set:
    """The keys of the JAX Solver's val stats over a confusion matrix."""
    stats = {"loss": 0.0, **jmetrics.confusion_to_point_metrics(cm)}
    stub = types.SimpleNamespace(compute_voxel_metrics=compute_voxel_metrics)
    if compute_voxel_metrics:
        stub.ctx = types.SimpleNamespace(sum_across_processes=lambda a: a)
        return set(jsolver.Solver._finish_voxel_stats(stub, stats, [0.5], [0.5], [0.5]))
    return set(jsolver.Solver._finish_voxel_stats(stub, stats, [], [], []))


def _solver(tmp_path, wholescene, compute_voxel_metrics, epochs=2):
    cfg = config.RunConfig(tag="voxel", data=config.DataConfig(**DATA),
                           train=config.TrainConfig(batch_size=4, epochs=epochs, verbose=0, seed=0,
                                                    wholescene=wholescene))
    store = synthetic.make_synthetic_store(4, seed=0, n_points=2000)
    if wholescene:
        train, val = WholeSceneDataset(store, cfg.data, seed=0), WholeSceneDataset(store, cfg.data, seed=1)
    else:
        train = chunks.ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
        val = chunks.ChunkedSceneDataset(store, cfg.data, phase="val", seed=1)
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**SPEC), generator=torch.Generator().manual_seed(0))
    cls = WholeSceneSolver if wholescene else Solver
    return cls(model, train, val, cfg, tmp_path, device="cpu", compute_voxel_metrics=compute_voxel_metrics)


@pytest.mark.parametrize("wholescene", [False, True], ids=["chunked", "wholescene"])
def test_without_voxel_metrics_val_stats_and_model_best_follow_point_miou(tmp_path, monkeypatch, wholescene):
    solver = _solver(tmp_path, wholescene, False)
    monkeypatch.setattr(solver, "_voxel_metrics", lambda *a: pytest.fail("voxel metrics computed"))
    seen, saved = [], []
    add, save = solver.logger.add_scalars, solver._save
    monkeypatch.setattr(solver.logger, "add_scalars",
                        lambda tag, stats, epoch: (tag == "val" and seen.append(dict(stats))) or add(tag, stats, epoch))
    monkeypatch.setattr(solver, "_save", lambda name, epoch: saved.append((name, epoch)) or save(name, epoch))
    best = solver()

    cm = np.zeros((20, 20), np.int64)
    assert len(seen) == 2
    for stats in seen:
        assert set(stats) == _jax_stat_keys(cm, False)
        assert stats["voxel_miou"] == stats["point_miou"]
    # model_best: each strictly better point mIoU, as the JAX Solver gates
    running, want = -1.0, []
    for epoch, stats in enumerate(seen):
        if stats["point_miou"] > running:
            running = stats["point_miou"]
            want.append(("model_best", epoch))
    assert [s for s in saved if s[0] == "model_best"] == want
    assert best["voxel_miou"] == best["point_miou"] == max(s["point_miou"] for s in seen)
    assert (tmp_path / "model_best.pt").exists()


@pytest.mark.parametrize("wholescene", [False, True], ids=["chunked", "wholescene"])
def test_with_voxel_metrics_val_stats_keep_the_jax_keys(tmp_path, wholescene):
    solver = _solver(tmp_path, wholescene, True, epochs=1)
    best = solver()
    assert set(best) - {"epoch"} == _jax_stat_keys(np.zeros((20, 20), np.int64), True)
    assert 0.0 <= best["voxel_miou"] <= 1.0
