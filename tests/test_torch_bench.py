"""The port's benchmark (bench_torch.py) and train_torch.py --trace, on the CPU.

- bench_torch.fwd_matmul_flops, the port's copy of bench.py's, gives
  bench.py's number exactly on the JAX package's SSG and MSG specs (and on
  the port's, which are the same architecture), at B 32 x 8192 and small.
- bench_torch.run("cpu") (the plain versions at B 2 x 1024) returns every
  field of its JSON row, rates positive, the eval cell's and the Solver
  cells' too (host path and device store, 3 epochs each), with the map of
  bench.py's fields that are not ported yet (bf16's alone); run in a
  process where importing jax or the JAX package fails.
- scripts/bench_hostpipe_torch.py at 8 scenes on the CPU prints its probes'
  JSON lines (the Solver's with --device_store), and with --host_only over
  cached scenes only probes 1 and 3.
- train_torch.py --trace DIR over 2 tiny epochs writes one trace file, of the
  second epoch, prints the capture line once and trains exactly as the same
  run without --trace.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re
import subprocess
import sys

import pytest

import bench
import bench_torch
from pointnet2_scannet_tpu import models as jax_models
from pointnet2_scannet_tpu_torch import models as port_models

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = (
    "metric", "value", "unit", "step_ms", "step_ms_min", "step_ms_max", "msg_points_per_sec", "msg_step_ms",
    "msg_step_ms_min", "msg_step_ms_max", "train_repeats", "fused_steps", "model_tflops_fwd", "mfu_f32",
    "serve_columns_per_sec_ssg", "serve_columns_per_sec_msg", "wholescene_ms_ssg", "wholescene_ms_msg",
    "p3_step_ms", "p3_step_ms_min", "p3_step_ms_max", "eval_scenes_per_sec", "eval_sps_min", "eval_sps_max",
    "eval_repeats", "solver_points_per_sec_host", "solver_points_per_sec_resident", "solver_fetch_ms_host",
    "solver_fetch_ms_resident", "solver_store_flatten_s", "solver_store_upload_s", "solver_scenes",
    "solver_steps_per_epoch", "device", "power_limit", "unported",
)
# the Solver cells' per-epoch lists (3 epochs)
EPOCH_FIELDS = tuple(f"solver_{k}_{path}" for k in ("epoch_s", "regen_join_s", "regen_s")
                     for path in ("host", "resident"))


@pytest.mark.parametrize("b,n", [(32, 8192), (2, 1024)])
@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_fwd_matmul_flops_equals_bench_py(kind, b, n):
    jax_spec = getattr(jax_models, f"{kind}_spec")(20, 6)
    port_spec = getattr(port_models, f"{kind}_spec")(20, 6)
    want = bench.fwd_matmul_flops(jax_spec, b, n)
    assert bench_torch.fwd_matmul_flops(jax_spec, b, n) == want
    assert bench_torch.fwd_matmul_flops(port_spec, b, n) == want > 0


def test_bench_torch_runs_on_the_cpu_without_jax():
    code = (
        "import json, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'pointnet2_scannet_tpu'): sys.modules[m] = None\n"
        "import bench_torch\n"
        "print(json.dumps(bench_torch.run('cpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(FIELDS) <= set(row), sorted(set(FIELDS) - set(row))
    assert row["metric"] == "train_points_per_sec_ssg_b32_n8192" and row["unit"] == "points/sec"
    assert (row["device"], row["power_limit"], row["mfu_f32"]) == ("cpu", None, None)
    assert (row["batch"], row["npoints"], row["train_repeats"], row["fused_steps"]) == (2, 1024, 3, 1)
    rates = [k for k in FIELDS if k not in ("metric", "unit", "device", "power_limit", "unported", "mfu_f32")]
    assert all(row[k] > 0 for k in rates), {k: row[k] for k in rates}
    assert row["step_ms_min"] <= row["step_ms"] <= row["step_ms_max"]
    assert row["value"] == pytest.approx(2 * 1024 / row["step_ms"] * 1e3)
    assert row["model_tflops_fwd"] == bench.fwd_matmul_flops(jax_models.ssg_spec(20, 6), 2, 1024) / 1e12
    assert row["eval_sps_min"] <= row["eval_scenes_per_sec"] <= row["eval_sps_max"] and row["eval_repeats"] == 1
    assert all(len(row[k]) == 3 and min(row[k]) > 0 for k in EPOCH_FIELDS), {k: row[k] for k in EPOCH_FIELDS}
    assert (row["solver_scenes"], row["solver_steps_per_epoch"]) == (8, 2)
    for path in ("host", "resident"):  # an epoch's points over the median of epochs 2 and 3
        steady = sorted(row[f"solver_epoch_s_{path}"][1:])
        assert row[f"solver_points_per_sec_{path}"] == pytest.approx(2 * 4 * 256 / (sum(steady) / 2))
    # bench.py's fields that are not ported: bf16's (item 10) alone
    assert row["unported"]["mfu_bf16"] == row["unported"]["ssg_bf16_points_per_sec"] == 10
    assert set(row["unported"].values()) == {10} and len(row["unported"]) == 9
    assert not set(row["unported"]) & set(row) and "vs_baseline" not in row


def _train(argv):
    spec = importlib.util.spec_from_file_location("train_torch", ROOT / "scripts" / "train_torch.py")
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_torch.train(train_torch.parse_args(argv))
    return out.getvalue()


def test_train_torch_trace_writes_one_trace_of_the_second_epoch(tmp_path):
    base = ["--device", "cpu", "--synthetic", "--synthetic_scenes", "4", "--npoints", "256", "--batch_size", "4",
            "--verbose", "1", "--use_color", "--use_normal", "--epoch", "2"]
    trace = tmp_path / "trace"
    plain = _train([*base, "--output_root", str(tmp_path / "plain")])
    traced = _train([*base, "--output_root", str(tmp_path / "traced"), "--trace", str(trace)])
    assert traced.count("capturing profiler trace") == 1 and "capturing" not in plain
    # the capture line falls between epoch 1's end and epoch 2's first step
    assert re.search(r"epoch \[1/2\] done.*\ncapturing profiler trace -> .*\nepoch \[2/2\] iter", traced)
    files = list(trace.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    losses = [re.findall(r"^epoch \[\d/2\] .*loss (\S+)", log, re.M) for log in (plain, traced)]
    assert len(losses[0]) == 4 and losses[0] == losses[1]


def test_bench_hostpipe_torch_runs_its_probes_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location("bench_hostpipe_torch",
                                                  ROOT / "scripts" / "bench_hostpipe_torch.py")
    hostpipe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hostpipe)
    out = io.StringIO()
    argv = ["--device", "cpu", "--scenes", "8", "--points", "4000", "--npoints", "256", "--batch_size", "4",
            "--store", str(tmp_path / "scenes"), "--device_store"]
    with contextlib.redirect_stdout(out):
        hostpipe.main(argv)
    rows = {r["metric"]: r for r in map(json.loads, out.getvalue().splitlines())}
    assert list(rows) == ["hostpipe_scene_gen_wall", "hostpipe_store_load_wall", "hostpipe_chunk_regen_wall",
                          "hostpipe_collate_epoch_wall", "hostpipe_train_points_per_sec"]
    assert all((r["device"], r["power_limit"]) == ("cpu", None) and r["value"] > 0 for r in rows.values())
    assert len(list((tmp_path / "scenes").glob("*.npy"))) == 8
    train = rows["hostpipe_train_points_per_sec"]
    assert train["device_store"] is True and train["steps_per_epoch"] == 2 and train["upload_s"] >= 0
    assert len(train["epoch_walls"]) == len(train["regen_join_wait_s"]) == 3
    assert len(train["regen_background_wall_s"]) == 2  # epochs 2 and 3 regenerate behind the steps
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # the scenes are cached: no generation, no Solver
        hostpipe.main([*argv[:-1], "--host_only"])
    metrics = [json.loads(line)["metric"] for line in out.getvalue().splitlines()]
    assert metrics == ["hostpipe_store_load_wall", "hostpipe_chunk_regen_wall", "hostpipe_collate_epoch_wall",
                       "hostpipe_peak_rss"]
