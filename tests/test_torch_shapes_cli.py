"""The port's shape-family CLIs on the CPU: one process per family runs
scripts/train_cls_torch.py (SSG) or train_partseg_torch.py (SSG) at batch 4
x 512 points for 1 epoch of 2 batches, --resume to epoch 2,
scripts/eval_shapes_torch.py (with --dump_ply for partseg) and
scripts/infer_torch.py --export on the run dir, each CLI as its own
__main__ in turn; a third process runs train_cls_torch.py --num_devices 2
(two gloo CPU ranks). The three run at once, each under its own timeout and
one intra-op thread. Then, in this process: the artifacts serve labels equal
to Predictor's on the run dir's checkpoint, scene inference of a shape run
exits with the JAX CLI's message, and a resume of a run without a
checkpoint fails before writing."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch.data import shapes
from pointnet2_scannet_tpu_torch.engine import export

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
SMALL = ["--device", "cpu", "--batch_size", "4", "--npoints", "512", "--epoch", "1", "--train_batches", "2",
         "--val_batches", "1", "--verbose", "1", "--tag", "t"]
# runs each argv as its script's __main__ in one process; "{run}" stands
# for the run dir the first command wrote (its stamp is known only then)
DRIVER = """
import json, pathlib, runpy, sys
root, argvs = json.loads(sys.argv[1])
for argv in argvs:
    runs = [str(p) for p in pathlib.Path(root).glob("*_T")]
    sys.argv = [runs[0] if a == "{run}" else a for a in argv]
    print("RUN", " ".join(sys.argv), flush=True)
    runpy.run_path(argv[0], run_name="__main__")
"""


def _chain(kind: str, out: pathlib.Path) -> tuple[subprocess.Popen, pathlib.Path]:
    """train, resume, eval, export of one family, in one process."""
    root = out / kind
    script = f"scripts/train_{kind}_torch.py"
    argvs = [
        [script, *SMALL, "--output_root", str(root)],
        [script, "--resume", "{run}", "--epoch", "2", "--device", "cpu"],
        ["scripts/eval_shapes_torch.py", "--folder", "{run}", "--batches", "2", "--device", "cpu",
         *(["--dump_ply", "2"] if kind == "partseg" else [])],
        ["scripts/infer_torch.py", "--folder", "{run}", "--export", str(out / f"{kind}.pt2"), "--device", "cpu",
         "--batch_size", "4"],
    ]
    return _launch(["-c", DRIVER, json.dumps([str(root), argvs])]), root


def _launch(argv: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: (stdout, run dir)} of the three processes, run at once."""
    out = tmp_path_factory.mktemp("shapes_cli")
    procs = {kind: _chain(kind, out) for kind in ("cls", "partseg")}
    procs["dp"] = (_launch(["scripts/train_cls_torch.py", *SMALL, "--train_batches", "1", "--num_devices", "2",
                            "--output_root", str(out / "dp")]), out / "dp")
    done = {}
    try:
        for kind, (p, root) in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, (kind, stderr[-3000:])
            (run,) = root.glob("*_T")
            done[kind] = (stdout, run)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    done["out"] = out
    return done


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", ["cls", "partseg"])
def test_train_resume_and_eval(runs, kind):
    stdout, run = runs[kind]
    for f in ("config.json", "info.json", "all_scalars.json", "model_best.pt", "model_last.pt",
              "model_last.train.pt", "model_last.meta.json", "model_best.meta.json"):
        assert (run / f).is_file(), f
    cfg = json.loads((run / "config.json").read_text())
    assert export.run_kind(cfg) == kind and cfg["epoch"] == 2 and cfg["device"] == "cpu"
    assert cfg["shape_classes"] == list(shapes.SHAPE_CLASSES[:8])
    if kind == "partseg":
        assert cfg["num_parts"] == 17 and cfg["batch_size"] == 4
    assert "resumed at epoch 1 (step 2," in stdout
    assert json.loads((run / "model_last.meta.json").read_text())["epoch"] == 1
    scalars = json.loads((run / "all_scalars.json").read_text())
    assert [s["epoch"] for s in scalars] == [1, 2]
    keys = {"val_acc"} | ({"val_part_miou", "val_ins_miou", "val_cat_miou"} if kind == "partseg" else set())
    for row in scalars:
        assert np.isfinite(row["train_loss"]) and set(row) == {"epoch", "train_loss"} | keys
        assert all(0.0 <= row[k] <= 1.0 for k in keys)
    if kind == "cls":
        assert "overall accuracy:" in stdout and "octahedron" in stdout
    else:
        assert "instance-avg mIoU:" in stdout and "category-avg mIoU:" in stdout
        assert len(list((run / "preds").glob("shape00[01]_*_*.ply"))) == 4


@pytest.mark.parametrize("kind", ["cls", "partseg"])
def test_export_serves_predictor_labels(runs, kind):
    stdout, run = runs[kind]
    assert "exported model_best" in stdout
    served = export.ServingPredictor.from_artifact(runs["out"] / f"{kind}.pt2", devices=["cpu"])
    eager = export.Predictor.from_run(run, batch_size=4, device="cpu")
    rng = np.random.default_rng(4)
    if kind == "cls":
        points = shapes.sample_cls_batch(rng, 6, 512, 8, augment=False)["points"]
        shape = (6,)
    else:
        points = shapes.sample_partseg_batch(rng, 6, 512, 8, augment=False)["points"]
        shape = (6, 512)
    got, want = served.predict(points), eager.predict(points)
    assert got.shape == shape and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert eager.predict(points[:0]).shape == (0,) + shape[1:]


def test_scene_inference_of_a_shape_run_exits(runs):
    import importlib.util

    spec = importlib.util.spec_from_file_location("infer_torch", ROOT / "scripts" / "infer_torch.py")
    infer_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(infer_torch)
    with pytest.raises(SystemExit, match="partseg run: scene inference .*eval_shapes_torch.py"):
        infer_torch.infer(infer_torch.parse_args(["--folder", str(runs["partseg"][1]), "--synthetic",
                                                  "--device", "cpu"]))


def test_two_gloo_ranks(runs):
    stdout, run = runs["dp"]
    assert "data parallel, 2 ranks (gloo)" in stdout and stdout.count("epoch 1/1: train loss") == 1
    assert json.loads((run / "info.json").read_text())["parallel"] == "data parallel, 2 ranks (gloo)"
    (row,) = json.loads((run / "all_scalars.json").read_text())
    assert np.isfinite(row["train_loss"])
    assert len(list(run.parent.iterdir())) == 1  # rank 0 alone wrote a run dir


def test_resume_without_a_checkpoint_fails(tmp_path):
    from pointnet2_scannet_tpu_torch.engine import shape_runs

    with pytest.raises(FileNotFoundError, match="model_last.pt"):
        shape_runs.main("cls", ["--resume", str(tmp_path), "--device", "cpu"])
    assert not any(tmp_path.iterdir())
