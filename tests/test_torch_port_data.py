"""The port's host data path against the JAX package's (numpy in both).

Synthetic scenes, whole-scene column stacks, dedup ids, class weights and
run configs must be identical bit for bit; the Predictor's padding and the
checkpoint round trip are checked on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import config as jconfig
from pointnet2_scannet_tpu.data import scene_store as jstore
from pointnet2_scannet_tpu.data import synthetic as jsynth
from pointnet2_scannet_tpu.data import wholescene as jwhole
from pointnet2_scannet_tpu.engine import metrics as jmetrics
from pointnet2_scannet_tpu.utils import native as jnative
from pointnet2_scannet_tpu_torch import config
from pointnet2_scannet_tpu_torch.data import scene_store, synthetic, wholescene
from pointnet2_scannet_tpu_torch.engine import checkpoint, export, metrics
from pointnet2_scannet_tpu_torch.utils import native, ply


@pytest.fixture(scope="module")
def stores():
    return (
        jsynth.make_synthetic_store(2, seed=1000),
        synthetic.make_synthetic_store(2, seed=1000),
    )


@pytest.mark.parametrize("seed", [0, 1000])
def test_synthetic_scene_is_identical(seed):
    np.testing.assert_array_equal(
        synthetic.make_synthetic_scene(seed, n_points=5000),
        jsynth.make_synthetic_scene(seed, n_points=5000),
    )


@pytest.mark.parametrize("index", [0, 1])
def test_wholescene_columns_are_bit_identical(stores, index):
    jst, pst = stores
    kw = dict(npoints=8192, use_color=True, use_normal=True)
    want = jwhole.WholeSceneDataset(jst, jconfig.DataConfig(**kw), seed=0).get_scene(index)
    got = wholescene.WholeSceneDataset(pst, config.DataConfig(**kw), seed=0).get_scene(index)
    assert got[0].shape[1:] == (8192, 9) and got[0].dtype == np.float32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_iter_scenes_and_filter_points_match(stores):
    jst, pst = stores
    kw = dict(npoints=1024, use_color=True)
    jit = jwhole.WholeSceneDataset(jst, jconfig.DataConfig(**kw), seed=3).iter_scenes()
    pit = wholescene.WholeSceneDataset(pst, config.DataConfig(**kw), seed=3).iter_scenes()
    for (jsid, (jf, jl, jw)), (psid, (pf, pl, pw)) in zip(jit, pit, strict=True):
        assert jsid == psid
        preds = (np.arange(jl.size) % 20).astype(np.int32)
        want = jmetrics.filter_points(jf[..., :3].reshape(-1, 3), preds, jl.reshape(-1), jw.reshape(-1))
        got = metrics.filter_points(pf[..., :3].reshape(-1, 3), preds, pl.reshape(-1), pw.reshape(-1))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_native_host_ops_match_the_jax_binding(stores):
    jst, _ = stores
    xyz = jst.scenes[jst.scene_ids[0]][:, :3]
    lo = xyz.min(0)
    zext = float(np.float32(xyz[:, 2].max() - lo[2]))
    for want, got in zip(
        jnative.tile_columns(xyz, lo, zext, 1.5, 0.01, 5, 5),
        native.tile_columns(xyz, lo, zext, 1.5, 0.01, 5, 5),
    ):
        np.testing.assert_array_equal(got, want)
    dup = np.concatenate([xyz[:500], xyz[100:300]])
    np.testing.assert_array_equal(
        native.coord_first_occurrence(dup), jnative.coord_first_occurrence(dup)
    )


def test_label_weights_and_features_match(stores):
    jst, pst = stores
    np.testing.assert_array_equal(pst.label_weights, jst.label_weights)
    scene = jst.scenes[jst.scene_ids[1]]
    kw = dict(use_color=True, use_normal=True, use_multiview=False)
    np.testing.assert_array_equal(
        scene_store.assemble_features(scene, None, **kw),
        jstore.assemble_features(scene, None, **kw),
    )


def test_run_config_reads_a_jax_config_json(tmp_path):
    jcfg = jconfig.RunConfig(
        tag="x", data=jconfig.DataConfig(npoints=4096, use_color=True, use_normal=True),
        model=jconfig.ModelConfig(num_classes=13), train=jconfig.TrainConfig(batch_size=8),
    )
    jcfg.save(tmp_path / "config.json")
    cfg = config.RunConfig.load(tmp_path / "config.json")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.data.input_channels == 6
    assert config.NUM_CLASSES == jconfig.NUM_CLASSES and config.PALETTE == jconfig.PALETTE
    assert export.run_kind({"model": {}, "data": {}}) == "semseg"


def test_predictor_pads_trims_and_matches_the_model(tmp_path):
    from pointnet2_scannet_tpu_torch.models import get_model

    cfg = config.RunConfig(data=config.DataConfig(npoints=256))
    cfg.save(tmp_path / "config.json")
    model = get_model(20, is_msg=False, input_channels=0, generator=torch.Generator().manual_seed(1))
    checkpoint.save_state_dict(tmp_path, "model_best", model.state_dict())
    pred = export.Predictor.from_run(tmp_path, batch_size=4, device="cpu", emit="logits")
    cols = np.random.default_rng(2).uniform(0, 1.5, (5, 256, 3)).astype(np.float32)
    logits = pred.predict(cols)
    assert logits.shape == (5, 256, 20)
    with torch.inference_mode():
        want = model(torch.from_numpy(cols[4:5])).numpy()
    np.testing.assert_allclose(logits[4:5], want, rtol=1e-5, atol=1e-5)
    labels = export.Predictor.from_run(tmp_path, batch_size=4, device="cpu").predict(cols)
    assert labels.dtype == np.int8 and labels.shape == (5, 256)
    np.testing.assert_array_equal(labels, logits.argmax(-1))
    assert pred.predict(cols[:0]).shape == (0, 256, 20)
    with pytest.raises(ValueError, match="expected"):
        pred.predict(cols[:, :100])


def test_checkpoint_round_trip_and_ply(tmp_path):
    state = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3), "b": torch.ones(2)}
    checkpoint.save_state_dict(tmp_path, "m", state)
    back = checkpoint.load_state_dict(tmp_path, "m")
    assert torch.equal(back["a.weight"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(back["b"], torch.ones(2))
    pts = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]], np.float32)
    ply.write_ply_points(tmp_path / "p.ply", pts, np.array([[1, 2, 3], [4, 5, 6]]))
    text = (tmp_path / "p.ply").read_text().splitlines()
    assert text[2] == "element vertex 2" and text[-1] == "3.0 4.0 5.0 4 5 6"
    assert metrics.pred_transfer_dtype(20) == torch.int8
    assert metrics.pred_transfer_dtype(200) == torch.int32
