"""The serving slice end to end on the CPU, and the port's import boundary.

A JAX run dir (config.json + JAX-initialised model_best.msgpack), of the SSG
model and of the MSG model, goes through scripts/jax_to_torch.py and is
served by scripts/infer_torch.py --device cpu --synthetic; its labels must
agree with the JAX forward's argmax on the same columns for at least 99.9%
of the points (the logits differ only by f32 matmul summation order).
"""

import importlib.util
import pathlib
import shutil
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import config as jconfig
from pointnet2_scannet_tpu.data import synthetic as jsynth
from pointnet2_scannet_tpu.data import wholescene as jwhole
from pointnet2_scannet_tpu.engine import metrics as jmetrics
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu_torch.engine import checkpoint
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from tests.test_torch_port_model import _randomize_bn

ROOT = pathlib.Path(__file__).resolve().parent.parent
NPOINTS = 2048


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(run, is_msg, npoints):
    """A JAX run dir with JAX-initialised weights, converted by
    scripts/jax_to_torch.py."""
    run.mkdir(parents=True, exist_ok=True)
    cfg = jconfig.RunConfig(
        tag="slice",
        data=jconfig.DataConfig(npoints=npoints, use_color=True, use_normal=True),
        model=jconfig.ModelConfig(is_msg=is_msg),
    )
    cfg.save(run / "config.json")
    model = jmodel.get_model(20, is_msg=is_msg, input_channels=6)
    x = jnp.zeros((1, npoints, 9), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(9))
    variables = _randomize_bn(variables, 9)
    (run / "model_best.msgpack").write_bytes(flax.serialization.msgpack_serialize(variables))
    _script("jax_to_torch").main(["--folder", str(run)])
    return run, cfg, model, variables


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_run"), False, NPOINTS)


def _assert_converted(run, variables, spec):
    got = checkpoint.load_state_dict(run, "model_best")
    want = convert.state_dict_from_jax(variables, spec)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    pointnet2.PointNet2SemSeg(spec).load_state_dict(got, strict=True)


def test_jax_to_torch_writes_the_converted_state_dict(jax_run):
    run, _, _, variables = jax_run
    _assert_converted(run, variables, pointnet2.ssg_spec(20, 6))


def test_jax_msg_run_converts_and_serves(tmp_path):
    run, cfg, model, variables = _jax_run(tmp_path / "run", True, 512)
    _assert_converted(run, variables, pointnet2.msg_spec(20, 6))
    _assert_served_labels_agree(run, cfg, model, variables, tmp_path / "pred")


def test_infer_torch_labels_agree_with_the_jax_forward(jax_run, tmp_path):
    _assert_served_labels_agree(*jax_run, tmp_path)


def _assert_served_labels_agree(run, cfg, model, variables, tmp_path):
    npoints = cfg.data.npoints
    infer_torch = _script("infer_torch")
    stats = infer_torch.infer(infer_torch.parse_args([
        "--folder", str(run), "--device", "cpu", "--synthetic", "--synthetic_scenes", "1",
        "--batch_size", "8", "--out", str(tmp_path), "--write_ply",
    ]))
    assert stats["scenes"] == 1 and stats["points"] == stats["columns"] * npoints
    got = np.load(tmp_path / "synth0000_00_pred.npy")
    assert (tmp_path / "synth0000_00_pred.ply").is_file()

    ds = jwhole.WholeSceneDataset(jsynth.make_synthetic_store(1, seed=1000), cfg.data, seed=0)
    feats, labels, weights = ds.get_scene(0)
    assert len(feats) == stats["columns"]
    logits = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(feats))
    preds = np.asarray(jnp.argmax(logits, -1)).reshape(-1).astype(np.int32)
    coords, preds, _, _ = jmetrics.filter_points(
        feats[..., :3].reshape(-1, 3), preds, labels.reshape(-1), weights.reshape(-1)
    )
    assert got.shape == (len(coords), 4)
    np.testing.assert_array_equal(got[:, :3], coords)
    agree = np.mean(got[:, 3].astype(np.int32) == preds)
    assert agree >= 0.999, agree


def test_infer_torch_rejects_a_shape_family_run(tmp_path):
    (tmp_path / "config.json").write_text('{"npoints": 1024, "classes": 40}')
    infer_torch = _script("infer_torch")
    with pytest.raises(SystemExit, match="cls run"):
        infer_torch.infer(infer_torch.parse_args(["--folder", str(tmp_path), "--device", "cpu"]))


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointnet2_scannet_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import runpy\n"
        "for s in ('scripts/infer_torch.py', 'scripts/train_torch.py', 'scripts/eval_torch.py',\n"
        "          'scripts/multiview_torch.py', 'scripts/bench_enet_torch.py', 'scripts/export_reference_torch.py',\n"
        "          'scripts/visualize_torch.py', 'scripts/train_cls_torch.py', 'scripts/train_partseg_torch.py',\n"
        "          'scripts/eval_shapes_torch.py', 'scripts/preprocess_torch.py', 'scripts/bench_hotops_torch.py',\n"
        "          'scripts/bench_fp_torch.py', 'scripts/bench_pregather_torch.py', 'chip_smoke.py', 'bench_torch.py'):\n"
        "    runpy.run_path(s, run_name='probe')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pointnet2_scannet_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "assert {'pointnet2_scannet_tpu_torch.parallel.distributed', 'pointnet2_scannet_tpu_torch.parallel.step',\n"
        "        'pointnet2_scannet_tpu_torch.data.shapes', 'pointnet2_scannet_tpu_torch.engine.shape_runs',\n"
        "        'pointnet2_scannet_tpu_torch.models.pointnet2_cls', 'pointnet2_scannet_tpu_torch.models.pointnet2_partseg',\n"
        "        'pointnet2_scannet_tpu_torch.data.scannet_prep', 'pointnet2_scannet_tpu_torch.utils.normals',\n"
        "        'pointnet2_scannet_tpu_torch.utils.scene_util', 'pointnet2_scannet_tpu_torch.utils.profiling'} <= set(mods)\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("alone", [False, True], ids=["in_checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
