"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, the yardstick's counts, the traffic's sizes, the card check
and the import rules."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    cells = len(bench["workloads"])
    # a full check of 24 cells must fit 43200 s at this run length
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[group]:
            assert NAME.match(item["name"]), item["name"]
            assert (group, item["name"]) not in names
            names.add((group, item["name"]))
            for key in ("why", "layer", "source"):
                if key in item and group in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(item[key]) <= 200 and "\n" not in item[key] and "\t" not in item[key]
            if "unit" in item:
                assert UNIT.match(item["unit"]) and item["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_cell_finds_its_files(bench):
    from pn2bench import harness

    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        driver = harness.driver_of(cell)
        assert callable(driver.run) and callable(driver.controls)
        assert callable(harness.builder_of(cell).build) and callable(harness.reference_of(cell).forward)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(harness.load_module(BENCH / "metrics" / f"{m['name']}.py").read)
        assert set(cell.limits) and all(isinstance(v, (int, float)) for v in cell.limits.values())
    for path in (BENCH / "roofline").glob("*.py"):
        op = harness.load_module(path)
        assert op.KERNELS.pattern and callable(op.work)


@pytest.mark.parametrize("kind,tflops", [("ssg", 0.07178), ("msg", 0.13218)])
def test_flops_match_bench_torch(kind, tflops):
    import bench_torch
    from pointnet2_scannet_tpu_torch.models import msg_spec, ssg_spec
    from pn2bench import yardstick

    model = json.loads((BENCH / "configs" / f"{kind}.json").read_text())["model"]
    ours = yardstick.fwd_matmul_flops(model, 32, 8192)
    spec = (msg_spec if kind == "msg" else ssg_spec)(20, 6)
    assert ours == bench_torch.fwd_matmul_flops(spec, 32, 8192)
    assert round(ours / 1e12, 5) == tflops


def test_train_traffic_same_seed_same_batches(bench):
    from conftest import small_cell
    from pn2bench import traffic

    mix = small_cell(bench, "ssg.train").mix
    a, b = traffic.train_pool(mix, 2**31 + 3, 20), traffic.train_pool(mix, 2**31 + 3, 20)
    batch = a.groups[0][0]
    assert batch["points"].shape == (2, 1024, 9) and batch["labels"].dtype == np.int32
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a.groups[0], b.groups[0]) for k in x)


def test_roofline_counts():
    from pn2bench import harness

    model = json.loads((BENCH / "configs" / "ssg.json").read_text())["model"]
    ops = {p.stem: harness.load_module(p) for p in (BENCH / "roofline").glob("*.py")}
    B, N = 32, 8192
    steps = N * 1024 + 1024 * 256 + 256 * 64 + 64 * 16
    assert ops["fps"].work(model, B, N, False) == (4.0 * B * (3 * (N + 1024 + 256 + 64) + 1024 + 256 + 64 + 16),
                                                   10.0 * B * steps)
    assert ops["three_nn"].work(model, B, N, True)[1] == 9.0 * B * (64 * 16 + 256 * 64 + 1024 * 256 + N * 1024)
    assert ops["ball_query"].work(model, B, N, False)[1] == 9.0 * B * 32 * (1024 + 256 + 64 + 16)
    assert ops["scatter_add"].work(model, B, N, False) == (0.0, 0.0)
    nbytes, nops = ops["gather"].work(model, B, N, False)
    assert nops == 0.0 and nbytes > 4.0 * B * 1024 * 32 * 9  # SA1's grouped rows at least


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ssg.train", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


_IMPORTS = """
import sys
sys.path[:0] = [{root!r}, {bench!r}]
{body}
top = {{m.split('.')[0] for m in sys.modules}}
print(sorted(top & {names!r}))
"""


def _loaded(body: str, names: set[str]) -> list[str]:
    code = _IMPORTS.format(root=str(ROOT), bench=str(BENCH), body=body, names=names)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_no_jax_after_a_cells_imports():
    body = ("import json, run, torch\nfrom pn2bench import harness, port\n"
            "bench = json.loads((harness.HERE.parent / 'BENCHMARK.json').read_text())\n"
            "for w in bench['workloads']:\n"
            "    cell = harness.find_cell(bench, w['name'])\n"
            "    harness.driver_of(cell), harness.reference_of(cell)\n"
            "    harness.builder_of(cell).build(cell.config['model'], torch.device('cpu'))\n"
            "assert 'pointnet2_scannet_tpu_torch' in sys.modules\n"
            "assert run.forbidden_modules() == []")
    assert _loaded(body, {"jax", "jaxlib", "flax", "pointnet2_scannet_tpu"}) == []


def test_reference_imports_nothing_of_the_port():
    body = "from reference import pointnet2"
    assert _loaded(body, {"pointnet2_scannet_tpu_torch", "pointnet2_scannet_tpu", "jax", "pn2bench"}) == []
