"""The port's training CLI (scripts/train_torch.py) and Solver end to end on
the CPU, at a tiny size: 4 synthetic scenes of which 256-point chunks are
cut, batch 4, so one optimizer step per epoch and one padded val batch.

The run prints the JAX package's ITER / EPOCH / BEST reports, writes the run
dir's artifacts, resumes from model_last with its full train state, and
its checkpoints are served by scripts/infer_torch.py. (--bf16 trains:
tests/test_torch_bf16_cli.py.) Its ScalarLogger
writes TensorBoard events where tensorboardX (or torch.utils.tensorboard)
imports, and all_scalars.json alone where neither does.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch.engine import checkpoint
from pointnet2_scannet_tpu_torch.engine.logging import ScalarLogger

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASE = ["--device", "cpu", "--synthetic", "--synthetic_scenes", "4", "--npoints", "256",
        "--batch_size", "4", "--verbose", "1", "--use_color", "--use_normal"]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train(argv):
    train_torch = _script("train_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run, best = train_torch.train(train_torch.parse_args(argv))
    return run, best, out.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_torch")
    return _train([*BASE, "--epoch", "2", "--tag", "t", "--output_root", str(root)])


def test_reports_print_and_the_artifacts_exist(run):
    run_dir, best, log = run
    assert run_dir.name.endswith("_T")
    iters = re.findall(r"^epoch \[(\d)/2\] iter \[1/1\] loss (\S+) point_acc", log, re.M)
    assert [e for e, _ in iters] == ["1", "2"]
    assert all(np.isfinite(float(loss)) for _, loss in iters)
    assert len(re.findall(r"^epoch \[\d/2\] done: train loss \S+ val loss \S+ val point_miou "
                          r"\S+ val voxel_miou \S+$", log, re.M)) == 2
    assert re.search(r"^best voxel_miou \S+ at epoch 0$", log, re.M)
    for name in ("config.json", "info.json", "best.txt", "model_best.pt", "model_last.pt",
                 "model_last.train.pt", "model_last.meta.json", "tensorboard/all_scalars.json"):
        assert (run_dir / name).is_file(), name
    cfg = json.loads((run_dir / "config.json").read_text())
    assert cfg["train"]["fused_steps"] == 8 and cfg["data"]["npoints"] == 256
    assert (run_dir / "best.txt").read_text().startswith(f"epoch: {best['epoch']}")
    scalars = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    assert [s for s, _ in scalars["train/loss"]] == [0, 1]
    assert {"val/voxel_miou", "val/point_miou", "val/loss"} <= set(scalars)
    meta = json.loads((run_dir / "model_last.meta.json").read_text())
    assert meta["epoch"] == 1 and meta["best"]["epoch"] == best["epoch"]
    state = torch.load(run_dir / "model_last.train.pt", weights_only=True)
    assert state["step"] == 2


def test_resume_continues_from_epoch_2(run, tmp_path):
    run_dir, _, _ = run
    copy = tmp_path / run_dir.name
    copy.mkdir()
    for f in run_dir.rglob("*"):
        if f.is_file():
            (copy / f.relative_to(run_dir)).parent.mkdir(parents=True, exist_ok=True)
            (copy / f.relative_to(run_dir)).write_bytes(f.read_bytes())
    before = checkpoint.load_state_dict(copy, "model_last")
    _, _, log = _train(["--device", "cpu", "--resume", str(copy), "--epoch", "3"])
    assert "(from epoch 2)" in log
    assert re.findall(r"^epoch \[(\d)/3\] iter", log, re.M) == ["3"]
    assert torch.load(copy / "model_last.train.pt", weights_only=True)["step"] == 3
    assert json.loads((copy / "model_last.meta.json").read_text())["epoch"] == 2
    after = checkpoint.load_state_dict(copy, "model_last")
    assert any(not torch.equal(before[k], after[k]) for k in before)
    # nothing more to train: the run dir is left as it was
    _, _, log = _train(["--device", "cpu", "--resume", str(copy), "--epoch", "3"])
    assert "(from epoch 3)" in log and " iter " not in log
    np.testing.assert_equal(
        {k: v.numpy() for k, v in checkpoint.load_state_dict(copy, "model_last").items()},
        {k: v.numpy() for k, v in after.items()},
    )


def test_resume_restores_the_whole_train_state(run):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import get_model

    run_dir, _, _ = run
    model = get_model(20, is_msg=False, input_channels=6, generator=torch.Generator().manual_seed(1))
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=5)
    meta = checkpoint.restore_checkpoint(run_dir, "model_last", state)
    saved = torch.load(run_dir / "model_last.train.pt", weights_only=True)
    assert meta["epoch"] == 1 and state.step == 2
    assert torch.equal(state.generator.get_state(), saved["generator"])
    adam = state.optimizer.state_dict()["state"]
    assert len(adam) == len(list(model.parameters()))
    assert all(float(s["step"]) == 2.0 for s in adam.values())
    for k, v in checkpoint.load_state_dict(run_dir, "model_last").items():
        assert torch.equal(model.state_dict()[k], v), k


def test_infer_torch_serves_the_run_dir(run, tmp_path):
    run_dir, _, _ = run
    infer_torch = _script("infer_torch")
    for ckpt in ("model_best", "model_last"):
        out = tmp_path / ckpt
        stats = infer_torch.infer(infer_torch.parse_args([
            "--folder", str(run_dir), "--checkpoint", ckpt, "--device", "cpu", "--synthetic",
            "--batch_size", "8", "--out", str(out),
        ]))
        assert stats["scenes"] == 1 and stats["points"] == stats["columns"] * 256
        pred = np.load(out / "synth0000_00_pred.npy")
        assert pred.shape[1] == 4 and np.isfinite(pred).all()
        assert set(np.unique(pred[:, 3])) <= set(range(20))


def test_msg_run_trains_and_infer_torch_serves_it(tmp_path):
    run_dir, _, log = _train([*BASE, "--use_msg", "--epoch", "1", "--tag", "msg",
                              "--output_root", str(tmp_path / "runs")])
    losses = re.findall(r"^epoch \[1/1\] iter \[1/1\] loss (\S+) point_acc", log, re.M)
    assert len(losses) == 1 and np.isfinite(float(losses[0]))
    assert json.loads((run_dir / "config.json").read_text())["model"]["is_msg"] is True
    state = checkpoint.load_state_dict(run_dir, "model_best")
    assert state["sa_0.mlp_1.dense_0.weight"].shape == (32, 9)  # the second scale
    infer_torch = _script("infer_torch")
    stats = infer_torch.infer(infer_torch.parse_args([
        "--folder", str(run_dir), "--device", "cpu", "--synthetic", "--batch_size", "8",
        "--out", str(tmp_path / "pred"),
    ]))
    assert stats["scenes"] == 1 and stats["points"] == stats["columns"] * 256
    pred = np.load(tmp_path / "pred" / "synth0000_00_pred.npy")
    assert pred.shape[1] == 4 and np.isfinite(pred).all()
    assert set(np.unique(pred[:, 3])) <= set(range(20))


@pytest.mark.parametrize(
    "flag",
    # data parallelism is ported (tests/test_torch_parallel_cli.py); --tp
    # (dp x tp) is not, and is refused alone and beside every dp flag
    [["--use_wholescene", "--tp", "2"], ["--num_devices", "2", "--tp", "2"],
     ["--tp", "2"], ["--dist_coordinator", "localhost:1234", "--tp", "2"],
     ["--dist_nprocs", "2", "--tp", "2"], ["--dist_auto", "--tp", "2"]],
    ids=lambda f: f[0].lstrip("-"),
)
def test_unported_flags_raise_with_their_roadmap_item(flag, tmp_path):
    train_torch = _script("train_torch")
    args = train_torch.parse_args([*BASE, "--output_root", str(tmp_path), *flag])
    for entry in (train_torch.main, train_torch.train):
        with pytest.raises(NotImplementedError, match=r"--tp: .*ROADMAP queue 1, item 12"):
            entry(args)
    assert not any(tmp_path.iterdir())  # raised before anything was written


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without a GPU")
def test_device_cuda_without_a_gpu_raises(tmp_path):
    train_torch = _script("train_torch")
    args = train_torch.parse_args([*BASE[2:], "--output_root", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_torch.train(args)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("writer", ["tensorboardX", None])
def test_scalar_logger_writes_events_where_a_writer_imports(tmp_path, monkeypatch, writer):
    if writer is None:  # neither writer imports
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    else:
        pytest.importorskip(writer)
    logger = ScalarLogger(tmp_path)
    logger.add_scalars("val", {"loss": 0.5, "point_miou": 0.25}, 0)
    logger.add_scalars("val", {"loss": 0.25, "point_miou": 0.5}, 1)
    logger.close()
    scalars = json.loads((tmp_path / "tensorboard" / "all_scalars.json").read_text())
    assert scalars == {"val/loss": [[0, 0.5], [1, 0.25]], "val/point_miou": [[0, 0.25], [1, 0.5]]}
    events = list((tmp_path / "tensorboard").glob("events.out.tfevents.*"))
    assert len(events) == (0 if writer is None else 1)
    if events:  # the event file names each tag
        assert b"val/loss" in events[0].read_bytes() and b"val/point_miou" in events[0].read_bytes()
