"""train_torch.py --bf16 and infer_torch.py on its run dir, on the CPU at a
tiny size (4 synthetic scenes, 256-point chunks, batch 4, one epoch).

--bf16 trains chunked, on whole scenes and from the device store: the run
prints its compute dtype, config.json records bfloat16, the losses are
finite and the checkpoints stay float32 (flax's dtype semantics: the
parameters never leave float32). infer_torch.py serves the run dir that
train_torch.py --bf16 --use_msg writes. (eval_torch.py and
visualize_torch.py on a bfloat16 run dir: tests/test_torch_eval.py.)
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch.engine import checkpoint

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


@pytest.mark.parametrize("mode", [[], ["--use_wholescene"], ["--device_store"]],
                         ids=["chunks", "wholescene", "device_store"])
def test_bf16_trains(mode, tmp_path):
    run_dir, best, log = _train([*BASE, "--epoch", "1", "--bf16", "--output_root", str(tmp_path), *mode])
    assert "compute dtype bfloat16" in log and "device_store disabled" not in log
    saved = json.loads((run_dir / "config.json").read_text())
    assert saved["model"]["compute_dtype"] == "bfloat16"
    assert saved["train"]["wholescene"] == ("--use_wholescene" in mode)
    assert saved["train"]["device_store"] == ("--device_store" in mode)
    scalars = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    assert all(np.isfinite(v) for _, v in scalars["train/loss"] + scalars["val/loss"])
    state = checkpoint.load_state_dict(run_dir, "model_best")
    assert {t.dtype for t in state.values() if t.is_floating_point()} == {torch.float32}


def test_infer_torch_serves_a_bf16_run_dir(tmp_path):
    run, _, _ = _train([*BASE, "--epoch", "1", "--use_msg", "--bf16", "--output_root", str(tmp_path / "runs")])
    infer_torch = _script("infer_torch")
    stats = infer_torch.infer(infer_torch.parse_args([
        "--folder", str(run), "--device", "cpu", "--synthetic", "--batch_size", "8",
        "--out", str(tmp_path / "pred")]))
    pred = np.load(tmp_path / "pred" / "synth0000_00_pred.npy")
    assert stats["scenes"] == 1 and pred.shape[1] == 4 and set(np.unique(pred[:, 3])) <= set(range(20))
