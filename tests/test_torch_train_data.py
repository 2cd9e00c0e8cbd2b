"""The port's chunked-training data path and metrics against the JAX
package's, on the CPU (numpy in both, so everything is bit for bit).

From the same seed the two ChunkedSceneDatasets cut the same chunks, draw
the same augmentations and weights, epoch after epoch (the async
regeneration included), and the two BatchLoaders assemble the same batches.
The confusion matrix (a device count in both) and the host metrics of a
validation epoch agree exactly.
"""

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import config as jconfig
from pointnet2_scannet_tpu.data import chunks as jchunks
from pointnet2_scannet_tpu.data import pipeline as jpipeline
from pointnet2_scannet_tpu.data import synthetic as jsynth
from pointnet2_scannet_tpu.engine import metrics as jmetrics
from pointnet2_scannet_tpu.utils import native as jnative
from pointnet2_scannet_tpu.utils import voxel as jvoxel
from pointnet2_scannet_tpu_torch import config
from pointnet2_scannet_tpu_torch.data import chunks, pipeline, synthetic
from pointnet2_scannet_tpu_torch.engine import metrics
from pointnet2_scannet_tpu_torch.utils import native, voxel

DATA = dict(npoints=256, use_color=True, use_normal=True)


@pytest.fixture(scope="module")
def stores():
    kw = dict(n_points=6000)
    return (
        jsynth.make_synthetic_store(5, seed=0, **kw),
        synthetic.make_synthetic_store(5, seed=0, **kw),
    )


def _datasets(stores, phase, seed):
    jst, pst = stores
    return (
        jchunks.ChunkedSceneDataset(jst, jconfig.DataConfig(**DATA), phase=phase, seed=seed),
        chunks.ChunkedSceneDataset(pst, config.DataConfig(**DATA), phase=phase, seed=seed),
    )


def _assert_same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_chunks_augmentations_and_weights_match_over_epochs(stores, phase):
    jds, pds = _datasets(stores, phase, seed=7)
    for epoch in range(3):
        for ds in (jds, pds):
            ds.generate_chunks()
            if epoch == 0:  # epoch 1 comes from the background regeneration
                ds.start_regen_async()
        assert list(pds.chunks) == list(jds.chunks)
        for sid, (chunk, mv) in jds.chunks.items():
            np.testing.assert_array_equal(pds.chunks[sid][0], chunk)
            assert mv is None and pds.chunks[sid][1] is None
        for i in range(len(jds)):
            for got, want in zip(pds.get_item(i), jds.get_item(i)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kind,kw",
    [("train", dict(drop_last=True)), ("train_shuffled", dict(drop_last=True, shuffle=True)),
     ("val", dict(pad_last=True))],
)
def test_batch_loader_gives_the_same_batches(stores, kind, kw):
    jds, pds = _datasets(stores, kind.split("_")[0], seed=3)
    jds.generate_chunks()
    pds.generate_chunks()
    jl = jpipeline.BatchLoader(jds, 2, seed=11, **kw)
    pl = pipeline.BatchLoader(pds, 2, seed=11, **kw)
    assert len(pl) == len(jl) == (2 if "drop_last" in kw else 3)
    for _ in range(2):  # a second pass draws the next shuffle
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(jl)
        for g, w in zip(got, want):
            _assert_same_batch(g, w)
    if "pad_last" in kw:
        np.testing.assert_array_equal(got[-1]["row_mask"], [1.0, 0.0])
        assert not got[-1]["points"][1].any()


def test_augmentation_draws_match():
    coords = np.random.default_rng(0).uniform(0, 1.5, (300, 3)).astype(np.float32)
    for seed in range(16):  # covers all eight cases
        want = jchunks.augment_coords(coords, np.random.default_rng(seed))
        got = chunks.augment_coords(coords, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        for g, w in zip(chunks.draw_augment_params(np.random.default_rng(seed)),
                        jchunks.draw_augment_params(np.random.default_rng(seed))):
            np.testing.assert_array_equal(np.asarray(g, dtype=float), np.asarray(w, dtype=float))


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
def test_chunk_scan_matches_the_jax_binding(stores, fallback, monkeypatch):
    jst, _ = stores
    scene = jst.scenes[jst.scene_ids[1]]
    xyz = np.ascontiguousarray(scene[:, :3], np.float32)
    labels = scene[:, 10].astype(np.int32)
    if fallback:
        monkeypatch.setattr(native._native, "_tried", True)
        monkeypatch.setattr(native._native, "_lib", None)
    else:
        assert native._native.lib is not None
    for k in range(4):
        center = xyz[k * 997]
        lo = (center - [0.75, 0.75, 1.5]).astype(np.float32)
        hi = (center + [0.75, 0.75, 1.5]).astype(np.float32)
        lo[2], hi[2] = xyz[:, 2].min(), xyz[:, 2].max()
        want = jnative.chunk_scan(xyz, labels, lo, hi, 0.2)
        got = native.chunk_scan(xyz, labels, lo, hi, 0.2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2] > 0


def test_confusion_matrix_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    labels = rng.integers(0, 20, (3, 400)).astype(np.int32)
    preds = np.where(rng.uniform(size=(3, 400)) < 0.6, labels, rng.integers(0, 20, (3, 400)))
    for mask in (None, np.array([1, 0, 1], np.float32)):
        want = jmetrics.confusion_matrix(
            jnp.asarray(preds), jnp.asarray(labels), 20, None if mask is None else jnp.asarray(mask)
        )
        got = metrics.confusion_matrix(
            torch.from_numpy(preds), torch.from_numpy(labels), 20,
            None if mask is None else torch.from_numpy(mask),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_equal(metrics.confusion_to_point_metrics(got.numpy()),
                                jmetrics.confusion_to_point_metrics(np.asarray(want)))


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
def test_scene_metrics_match_jax(stores, fallback, monkeypatch):
    jds, _ = _datasets(stores, "val", seed=1)
    jds.generate_chunks()
    feats, labels, weights = jds.get_item(0)
    coords = np.concatenate([feats[:, :3], feats[:50, :3]])  # duplicate rows to dedup
    targets = np.concatenate([labels, labels[:50]])
    w = np.concatenate([weights, weights[:50]])
    preds = np.where(np.arange(len(targets)) % 3 == 0, (targets + 1) % 20, targets).astype(np.int32)
    want = jmetrics.compute_scene_metrics(coords, preds, targets, w, 20)
    if fallback:
        monkeypatch.setattr(native._native, "_tried", True)
        monkeypatch.setattr(native._native, "_lib", None)
    got = metrics.compute_scene_metrics(coords, preds, targets, w, 20)
    for g_tier, w_tier in zip(got, want):
        for g, v in zip(g_tier, w_tier):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(v))
    for g, v in zip(voxel.surface_voxel_labels(coords, targets, res=0.02),
                    jvoxel.surface_voxel_labels(coords, targets, res=0.02)):
        np.testing.assert_array_equal(g, v)


def test_prefetch_on_the_cpu_passes_batches_through(stores):
    _, pds = _datasets(stores, "val", seed=2)
    pds.generate_chunks()
    loader = pipeline.BatchLoader(pds, 2, pad_last=True)
    host = list(loader)
    placed = list(pipeline.prefetch_to_device(iter(loader), device="cpu"))
    pairs = list(pipeline.prefetch_to_device(iter(loader), device="cpu", keep_host=True))
    assert len(placed) == len(pairs) == len(host) == 3
    for h, p, (h2, p2) in zip(host, placed, pairs):
        _assert_same_batch(h2, h)
        for k, v in h.items():
            assert isinstance(p[k], torch.Tensor) and p[k].device.type == "cpu"
            np.testing.assert_array_equal(p[k].numpy(), v)
            np.testing.assert_array_equal(p2[k].numpy(), v)
