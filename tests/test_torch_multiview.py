"""The port's multiview projection (data/multiview.py), its CLI
(scripts/multiview_torch.py) and the mv131 model against the JAX package on
the CPU.

Correspondence: a synthetic scene seen by cameras that look into it, with
depths rendered from its points (data/synthetic.make_synthetic_views), plus
points behind the first camera and points closer than 0.65 m in front of it
(their pixels' depths set to theirs, so only the reference's quantised
frustum culls them). valid and pix must equal the JAX package's (its jitted
batch and its eager single frame) except for boundary flips: at most one
(frame, point) pair in 10^5, each within 1e-4 of a decision threshold in
that decision's units (measured: none at 20 000 points x 8 frames here, and
none at 100 000 x 16). project_frame_features and fuse_scene_features equal
the JAX functions bit for bit, coverage ties included. process_scene of the
port's CLI on the JAX pipeline test's 48 x 32 synthetic frames equals the
JAX CLI's with the same ENet weights to the ENet tolerance
(tests/test_torch_enet.py). An mv131 model (131 input channels) at small
width matches the JAX model's logits to 1e-4 and takes the pregather at SA1.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.data import multiview as jmv
from pointnet2_scannet_tpu.models import enet as jenet
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu_torch.data import multiview as mv
from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore
from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene, make_synthetic_views
from pointnet2_scannet_tpu_torch.models import enet
from pointnet2_scannet_tpu_torch.ops import tuning
from tests.test_torch_enet import ATOL as ENET_ATOL
from tests.test_torch_enet import RTOL as ENET_RTOL
from tests.test_torch_enet import _random_weights, _write_reference_pth
from tests.test_torch_port_model import SMALL, _both

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLIP_SHARE, FLIP_MARGIN = 1e-5, 1e-4
NEAR, BEHIND = 300, 300  # extra points before the first camera


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small shapes gain little from more, which
    would only contend with the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def views():
    """(points (N, 3), depths (F, H, W), poses (F, 4, 4), index of the
    extra points) of a synthetic scene."""
    cam = mv.CameraConfig()
    scene = make_synthetic_scene(5, n_points=20_000)
    poses, depths = make_synthetic_views(scene, 8, cam, seed=1)
    rng = np.random.default_rng(2)
    z = np.concatenate([rng.uniform(0.12, 0.64, NEAR), rng.uniform(-2.0, -0.05, BEHIND)])
    local = np.column_stack([rng.uniform(-0.3, 0.3, z.size) * np.abs(z), rng.uniform(-0.2, 0.2, z.size) * np.abs(z), z])
    extra = (local @ poses[0, :3, :3].T.astype(np.float64) + poses[0, :3, 3]).astype(np.float32)
    u = np.round(local[:NEAR, 0] * cam.fx / z[:NEAR] + cam.cx).astype(int)
    v = np.round(local[:NEAR, 1] * cam.fy / z[:NEAR] + cam.cy).astype(int)
    depths[0, v, u] = z[:NEAR]
    points = np.concatenate([scene[:, :3], extra]).astype(np.float32)
    return points, depths, poses, np.arange(len(scene), len(points))


def _flips(got_v, got_p, want_v, want_p, margins):
    """Count the (frame, point) pairs that differ; each must lie within
    FLIP_MARGIN of a decision threshold."""
    differ = (got_v != want_v) | (got_p != want_p)
    assert differ.sum() <= FLIP_SHARE * differ.size, differ.sum()
    assert (margins[differ] <= FLIP_MARGIN).all(), margins[differ]
    return int(differ.sum())


def test_correspondence_matches_jax(views):
    points, depths, poses, extra = views
    valid, pix = (t.numpy() for t in mv.compute_correspondence_batch(torch.from_numpy(points), depths, poses))
    assert valid.shape == pix.shape == (8, len(points)) and pix.dtype == np.int32
    want_v, want_p = (np.asarray(t) for t in jmv.compute_correspondence_batch(
        jnp.asarray(points), jnp.asarray(depths), jnp.asarray(poses), jmv.CameraConfig()))
    margins = mv.decision_margins(torch.from_numpy(points), depths, poses).numpy()
    _flips(valid, pix, want_v, want_p, margins)
    # the extra points: none valid (behind the camera, or culled by the
    # quantised frustum though their pixels' depths agree), pix 0
    assert not valid[0, extra].any() and not (pix[0, extra]).any()
    near = mv._predicate(torch.from_numpy(points[extra[:NEAR]]), depths[:1], poses[:1], mv.CameraConfig())
    assert int((((near["d"] - near["z"]).abs() <= 0.05) & (near["d"] >= 0.1)).sum()) >= NEAR // 4
    assert 0.005 < valid.mean() and (pix[~valid] == 0).all()
    for f in (0, 3):  # the eager single-frame JAX function
        v1, p1 = mv.compute_correspondence(torch.from_numpy(points), depths[f], poses[f])
        v2, p2 = jmv.compute_correspondence(jnp.asarray(points), jnp.asarray(depths[f]), jnp.asarray(poses[f]))
        _flips(v1.numpy(), p1.numpy(), np.asarray(v2), np.asarray(p2), margins[f])


def test_projection_and_fusion_equal_jax_bit_for_bit(views):
    points, depths, poses, _ = views
    valid, pix = mv.compute_correspondence_batch(torch.from_numpy(points), depths, poses)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(8, 32, 41, 16)).astype(np.float32)
    for f in (0, 5):
        got = mv.project_frame_features(torch.from_numpy(feats[f]), valid[f], pix[f], len(points))
        want = jmv.project_frame_features(feats[f], valid[f].numpy(), pix[f].numpy(), len(points))
        np.testing.assert_array_equal(got.numpy(), want)
    # coverage ties: frame 1's mask again as frames 8 and 9 with other
    # features (the stable sort takes 1, then 8, then 9)
    feats = np.concatenate([feats, rng.normal(size=(2, 32, 41, 16)).astype(np.float32)])
    valid = torch.cat([valid, valid[1:2], valid[1:2]])
    pix = torch.cat([pix, pix[1:2], pix[1:2]])
    got = mv.fuse_scene_features(torch.from_numpy(feats), valid, pix).numpy()
    want = jmv.fuse_scene_features(feats, valid.numpy(), pix.numpy())
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (np.abs(got).sum(1) > 0).mean() < 1.0


def test_fusion_unit_cases_as_the_jax_tests():
    frame_feats = torch.stack([torch.full((1, 2, 1), 1.0), torch.full((1, 2, 1), 2.0)])
    out = mv.fuse_scene_features(frame_feats, torch.tensor([[True, False], [True, True]]),
                                 torch.zeros((2, 2), dtype=torch.int32))
    assert out[:, 0].tolist() == [2.0, 2.0]  # the more-covering frame wins
    out = mv.fuse_scene_features(torch.ones((1, 1, 1, 2)), torch.tensor([[False, True]]),
                                 torch.zeros((1, 2), dtype=torch.int32))
    assert out.tolist() == [[0.0, 0.0], [1.0, 1.0]]
    cam = mv.CameraConfig()
    depth = np.full((cam.height, cam.width), 2.0, np.float32)
    valid, pix = mv.compute_correspondence(torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, -2.0]]), depth, np.eye(4))
    assert valid.tolist() == [True, False] and pix.tolist() == [16 * cam.width + 20, 0]


def test_multiview_h5_reaches_the_scene_store(tmp_path):
    scenes = {f"s{i}": make_synthetic_scene(i, n_points=500) for i in range(2)}
    feats = {sid: np.random.default_rng(1).normal(size=(500, 128)).astype(np.float32) for sid in scenes}
    for sid, scene in scenes.items():
        np.save(tmp_path / f"{sid}.npy", scene)
    mv.write_multiview_h5(tmp_path / "mv.h5", feats)
    store = SceneStore.from_npy_dir(list(scenes), tmp_path, tmp_path / "mv.h5")
    for sid in scenes:
        np.testing.assert_array_equal(store.multiview[sid], feats[sid])


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_process_scene_matches_the_jax_cli(tmp_path, monkeypatch):
    import imageio.v2 as imageio

    ours = _script(ROOT / "scripts" / "multiview_torch.py", "multiview_torch")
    theirs = _script(ROOT / "scripts" / "multiview.py", "multiview_jax_cli")
    for cli in (ours, theirs):  # the JAX pipeline test's tiny camera
        monkeypatch.setattr(cli, "COLOR_DIMS", (48, 32))
        monkeypatch.setattr(cli, "DEPTH_DIMS", (6, 4))
    cams = [m.CameraConfig(fx=5.0, fy=5.0, cx=3.0, cy=2.0, width=6, height=4) for m in (mv, jmv)]
    rng = np.random.default_rng(0)
    points = np.column_stack([rng.uniform(-0.5, 0.5, 200), rng.uniform(-0.3, 0.3, 200),
                              np.full(200, 2.0)]).astype(np.float32)
    scene_dir = tmp_path / "frames" / "scene0000_00"
    for sub in ("color", "depth", "pose"):
        (scene_dir / sub).mkdir(parents=True)
    for fid in ("0", "100", "200"):
        imageio.imwrite(scene_dir / "color" / f"{fid}.jpg", rng.integers(0, 255, size=(32, 48, 3)).astype(np.uint8))
        imageio.imwrite(scene_dir / "depth" / f"{fid}.png", np.full((4, 6), 2000, np.uint16))
        np.savetxt(scene_dir / "pose" / f"{fid}.txt", np.eye(4))

    weights = _random_weights(1)
    _write_reference_pth(tmp_path / "enet.pth", weights)
    encoder = ours.load_encoder(tmp_path / "enet.pth", "cpu")
    got = ours.process_scene("scene0000_00", tmp_path / "frames", points, encoder, 2, cams[0], "cpu")
    full = jenet.load_torch_enet_weights(str(tmp_path / "enet.pth"))
    variables = {"params": full["params"]["encoder"], "batch_stats": full["batch_stats"]["encoder"]}
    apply = jax.jit(lambda v, x: jenet.ENetEncoder().apply(v, x, train=False))
    want = theirs.process_scene("scene0000_00", tmp_path / "frames", points, apply, variables, 2, cams[1])
    assert got.shape == (200, 128) and (np.abs(got).sum(1) > 0).mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=ENET_RTOL, atol=ENET_ATOL)


def test_mv131_model_matches_jax_and_pregathers_at_sa1():
    spec = dict(SMALL, input_channels=131)
    jm, variables, pm, pc = _both(spec, batch=2, n=256, seed=5)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    tuning.reset_route_counts()
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    # SA1 (64 centroids here) runs layer 0 before the gather: c_in 134 >= 2 x 8
    assert {k: n for k, n in tuning.route_counts.items() if k[0] == "pregather"} == {("pregather", 64): 1}
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # float64 never pregathers (the parity tests pin the unfused composition)
    tuning.reset_route_counts()
    with torch.inference_mode():
        pm.double()(torch.from_numpy(pc).double())
    assert not any(k[0] == "pregather" for k in tuning.route_counts)
