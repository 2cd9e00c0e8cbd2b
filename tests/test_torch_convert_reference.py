"""Reference-format checkpoints in the port (models/convert.py) against the
JAX package's on the CPU.

tests/test_convert.py's fake_reference_state_dict (the reference's key
scheme and shapes) goes through both packages: the port's
convert_torch_pointnet2 must equal the JAX route,
state_dict_from_jax(convert_torch_pointnet2(sd)), bit for bit; export then
import round-trips exactly; the imported model's logits match the JAX
model's on the same variables to rtol = atol = 1e-4 (float32 matrix
products sum in another order in XLA and in PyTorch's CPU BLAS), with the
fake weights scaled by 1 / sqrt(fan_in) so the logits stay near 1. The
export CLI runs on a run dir that scripts/train_torch.py wrote.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import models as jmodels
from pointnet2_scannet_tpu.models.convert import convert_torch_pointnet2 as jax_convert
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from tests.test_convert import fake_reference_state_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-4  # f32 matmul summation order (XLA vs PyTorch CPU BLAS)
KINDS = ["ssg", "msg"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small shapes gain little from more, which
    would only contend with the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(kind):
    make = (jmodels.msg_spec, pointnet2.msg_spec) if kind == "msg" else (jmodels.ssg_spec, pointnet2.ssg_spec)
    return make[0](20, 6), make[1](20, 6)


def _reference_sd(jspec, seed):
    """fake_reference_state_dict with seeded, fan-in-scaled weights and
    non-trivial BatchNorm statistics (so a swapped key cannot pass)."""
    rng = np.random.default_rng(seed)
    sd = fake_reference_state_dict(jspec)
    for k, v in sd.items():
        if k.endswith("conv.weight"):
            sd[k] = (rng.normal(size=v.shape) / np.sqrt(v.shape[1])).astype(np.float32)
        elif k.endswith(("bn.weight", "running_var")):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("bn.bias", "running_mean")):
            sd[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return sd


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_import_equals_the_jax_route(kind):
    jspec, pspec = _specs(kind)
    sd = fake_reference_state_dict(jspec)
    _assert_same(convert.convert_torch_pointnet2(sd, pspec),
                 convert.state_dict_from_jax(jax_convert(dict(sd), jspec), pspec))
    # torch tensors in, as torch.load gives them: the same arrays
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    _assert_same(convert.convert_torch_pointnet2(tensors, pspec), convert.convert_torch_pointnet2(sd, pspec))


@pytest.mark.parametrize("kind", KINDS)
def test_export_then_import_round_trips(kind):
    jspec, pspec = _specs(kind)
    sd = _reference_sd(jspec, 1)
    _assert_same(convert.export_torch_pointnet2(convert.convert_torch_pointnet2(sd, pspec), pspec), sd)
    model = pointnet2.get_model(20, is_msg=kind == "msg", input_channels=6,
                                generator=torch.Generator().manual_seed(2))
    ours = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_same(convert.convert_torch_pointnet2(convert.export_torch_pointnet2(model.state_dict(), pspec), pspec),
                 ours)


@pytest.mark.parametrize("kind", KINDS)
def test_imported_logits_match_jax(kind):
    jspec, pspec = _specs(kind)
    sd = _reference_sd(jspec, 3)
    pc = np.random.default_rng(4).uniform(0, 1.5, (1, 1024, 9)).astype(np.float32)
    jm = jmodels.PointNet2SemSeg(spec=jspec)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_convert(dict(sd), jspec), pc))
    pm = pointnet2.PointNet2SemSeg(pspec)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in convert.convert_torch_pointnet2(sd, pspec).items()},
                       strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(pc)).numpy()
    assert 0.1 < np.abs(want).max() < 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_unconsumed_tensors_and_a_deep_head_raise():
    jspec, pspec = _specs("ssg")
    sd = fake_reference_state_dict(jspec)
    sd["SA_modules.9.bogus"] = np.zeros(3)
    with pytest.raises(ValueError, match="unconsumed"):
        convert.convert_torch_pointnet2(sd, pspec)
    deep = pointnet2.PointNet2Spec(**{**pspec.__dict__, "cls_fc": (128, 64)})
    with pytest.raises(ValueError, match="single-layer cls_fc"):
        convert.export_torch_pointnet2({}, deep)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_cli_writes_a_loadable_pth(tmp_path):
    train_torch, export = _script("train_torch"), _script("export_reference_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        run, _ = train_torch.train(train_torch.parse_args([
            "--device", "cpu", "--synthetic", "--synthetic_scenes", "2", "--npoints", "256",
            "--batch_size", "2", "--epoch", "1", "--verbose", "1", "--use_normal", "--use_msg",
            "--output_root", str(tmp_path)]))
        out = export.export(export.parse_args(["--folder", str(run)]))
    assert out == run / "model_best.pth"
    ref = torch.load(out, map_location="cpu", weights_only=True)
    assert ref["SA_modules.0.mlps.1.layer0.conv.weight"].shape == (32, 6, 1, 1)
    assert ref["cls_layer.2.conv.weight"].shape == (20, 128, 1)
    spec = pointnet2.msg_spec(20, 3)
    back = convert.load_torch_pointnet2(out, spec)
    saved = torch.load(run / "model_best.pt", map_location="cpu", weights_only=True)
    _assert_same(back, {k: v.numpy() for k, v in saved.items()})
