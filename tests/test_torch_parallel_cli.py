"""The port's data-parallel CLIs on gloo CPU ranks: scripts/train_torch.py
in the two-process --dist_* form and resumed with --num_devices 2,
scripts/eval_torch.py on two --dist_* ranks (its --num_devices spawns
through the same code as train_torch.py's; scripts/visualize_torch.py runs
on two ranks in chip_smoke.py), and the refusals. Every process runs under its own timeout and is killed past it
(as tests/test_multihost.py runs the JAX CLIs)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pointnet2_scannet_tpu_torch.parallel import distributed as D

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
# 8 synthetic train scenes (2 val) at global batch 8: 4 scenes and one step
# of 4 rows a rank an epoch, one val scene a rank
TRAIN = ["--device", "cpu", "--synthetic", "--synthetic_scenes", "8", "--npoints", "256", "--batch_size", "8",
         "--verbose", "1", "--use_color", "--use_normal"]


def _launch(script: str, argv: list) -> subprocess.Popen:
    # one intra-op thread a process: the toy model gains nothing from more,
    # which would only contend with the other workers of a parallel test run
    return subprocess.Popen([sys.executable, str(ROOT / "scripts" / script), *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def _join(procs: list) -> list[str]:
    """Each process's stdout, once all exited 0; any past TIMEOUT_S is killed."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_PORTS: dict = {}


def _dist(pid: int) -> list:
    """The --dist_* flags of rank pid of a two-process run (a port per run,
    drawn by rank 0's caller)."""
    if pid == 0:
        _PORTS["last"] = D.free_port()
    return ["--dist_coordinator", f"127.0.0.1:{_PORTS['last']}", "--dist_nprocs", "2", "--dist_pid", str(pid)]


def _script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process too (the single-process eval)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """One epoch trained by two processes joined with the --dist_* flags,
    each with its own --output_root."""
    tmp = tmp_path_factory.mktemp("dist")
    coord = f"127.0.0.1:{D.free_port()}"
    roots = [tmp / f"out{p}" for p in range(2)]
    outs = _join([_launch("train_torch.py", [*TRAIN, "--epoch", "1", "--dist_coordinator", coord,
                                             "--dist_nprocs", "2", "--dist_pid", str(p), "--output_root",
                                             str(roots[p])]) for p in range(2)])
    return roots, outs


def test_dist_ranks_train_and_only_the_coordinator_writes(dist_run):
    roots, (out0, out1) = dist_run
    assert "parallel strategy: process_dp (mesh size 2, processes 2)" in out0
    assert "1 steps per epoch" in out0 and "best:" in out0
    runs = list(roots[0].iterdir())
    assert len(runs) == 1, runs
    for f in ("config.json", "info.json", "model_last.pt", "model_last.train.pt", "model_last.meta.json",
              "best.txt", "tensorboard/all_scalars.json"):
        assert (runs[0] / f).exists(), f
    assert not roots[1].exists()  # rank 1 wrote nothing
    assert "epoch [1/1]" not in out1 and "best:" not in out1  # and printed no report
    cfg = json.loads((runs[0] / "config.json").read_text())
    assert cfg["train"]["num_devices"] == 2 and cfg["train"]["batch_size"] == 8
    train = torch.load(runs[0] / "model_last.train.pt", weights_only=True)
    assert len(train["generators"]) == 2  # every rank's Dropout stream, for a resume
    assert not torch.equal(train["generators"][0], train["generators"][1])


@pytest.fixture(scope="module")
def after_run(dist_run, tmp_path_factory):
    """On the trained run: a resume to epoch 2 with --num_devices 2 (on a
    copy), eval_torch.py on two --dist_* ranks, and the single-process
    evaluation in this process (on another copy)."""
    import shutil

    roots, _ = dist_run
    run = next(roots[0].iterdir())
    tmp = tmp_path_factory.mktemp("after")
    resumed, single_run = shutil.copytree(run, tmp / "resumed"), shutil.copytree(run, tmp / "single")
    before = json.loads((run / "tensorboard" / "all_scalars.json").read_text())
    # one scene: rank 1's shard is empty, and it still joins the merge
    argv = ["--synthetic", "--synthetic_scenes", "1", "--batch_size", "32", "--device", "cpu"]
    outs = _join([_launch("train_torch.py", ["--resume", str(resumed), "--epoch", "2", "--synthetic",
                                             "--device", "cpu", "--num_devices", "2"])])
    outs += _join([_launch("eval_torch.py", ["--folder", str(run), *argv, *_dist(p)]) for p in range(2)])
    eval_torch = _script("eval_torch")
    single = eval_torch.evaluate(eval_torch.parse_args(["--folder", str(single_run), *argv])).format_table()
    return {"run": run, "resumed": resumed, "before": before, "single": single, "outs": outs}


def test_resume_with_num_devices_starts_at_the_next_epoch(after_run):
    out, resumed = after_run["outs"][0], after_run["resumed"]
    assert "(from epoch 1)" in out and "epoch [2/2]" in out and "epoch [1/2]" not in out
    assert json.loads((resumed / "model_last.meta.json").read_text())["epoch"] == 1
    scalars = json.loads((resumed / "tensorboard" / "all_scalars.json").read_text())
    assert len(after_run["before"]["train/loss"]) == 1 and [step for step, _ in scalars["train/loss"]] == [1]
    assert len(list(resumed.parent.iterdir())) == 2  # resumed in place, no other run dir


def test_eval_on_two_ranks_gives_the_single_process_report(after_run):
    assert (after_run["run"] / "eval_report.txt").read_text() == after_run["single"]
    assert [out.count("Voxel mIoU") for out in after_run["outs"][1:3]] == [1, 0]  # rank 0 alone prints it


@pytest.mark.parametrize("flags,error,match", [
    (["--tp", "2"], NotImplementedError, r"--tp: tensor parallelism .*ROADMAP queue 1, item 12"),
    (["--num_devices", "2", "--dist_coordinator", "127.0.0.1:1"], ValueError, "cannot be combined with --dist_"),
    (["--num_devices", "2", "--dist_auto"], ValueError, "cannot be combined with --dist_"),
    (["--num_devices", "64", "--device", "cuda"], ValueError,
     r"64 ranks on this host but only \d+ CUDA device\(s\)"),
], ids=["tp", "num_devices_with_dist_coordinator", "num_devices_with_dist_auto", "more_ranks_than_cards"])
def test_train_refusals(tmp_path, flags, error, match):
    train_torch = _script("train_torch")
    with pytest.raises(error, match=match):
        train_torch.main(train_torch.parse_args([*TRAIN, "--output_root", str(tmp_path), *flags]))
    assert not tmp_path.exists() or not any(tmp_path.iterdir())


def test_ranks_never_share_a_card():
    D.check_ranks_fit(2, 2)
    with pytest.raises(ValueError, match="3 ranks on this host but only 2 CUDA device"):
        D.check_ranks_fit(3, 2)
    assert D.dropout_seed(5, 0) == 5 and len({D.dropout_seed(5, r) for r in range(4)}) == 4
