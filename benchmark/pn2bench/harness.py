"""The harness: finds a cell's files by the names in BENCHMARK.json, runs
its driver once, reads the metrics the cell reports and decides `correct`.

By name, under the benchmark's directory:
- configs/<config>.json: the model configuration as it is run; its
  "builder" names pn2bench/builders/<builder>.py (build(model_cfg, device)
  -> the program's model) and its "reference" the plain reference's file;
- mixes/<traffic>.json: the traffic's parameters; its "driver" names
  pn2bench/drivers/<driver>.py, which makes the traffic from the seed,
  drives the window and the check (run(ctx), below) and reads the control
  and the planted faults that set the limits (controls(ctx), after run);
- limits/<cell>.json: the limit of each number the cell compares;
- metrics/<metric>.py: read(run) -> value or None, for each per-layer
  metric;
- roofline/<op>.py: KERNELS (a regular expression over kernel names) and
  work(model, B, N, train) -> (bytes, operations) of one batch.
A new cell, driver, model family, metric or op needs new files and entries
only.

A driver's run(ctx) returns its measurements: "kind" (the label the
metrics read, such as "train"), "devices" (those the run used; the result
reports their count), "attempted", "failed", "metrics" (every end-to-end
metric of its cells but setup_s), "memory_peak_bytes" (the fullest
device's), "checks" (each compared number); with a trace also "trace"
(profile.Trace) and, where it has them, "trace_calls" and
"capture_launches"; and whatever its cells' metrics read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import re
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent.parent  # the benchmark's directory


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"_bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def find_cell(bench: dict, name: str, root: pathlib.Path = HERE) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = load_json(root / "configs" / f"{w['config']}.json")
    mix = load_json(root / "mixes" / f"{w['traffic']}.json")
    limits = load_json(root / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name, config, mix, limits, e2e, per_layer)


def driver_of(cell: Cell):
    return importlib.import_module(f"pn2bench.drivers.{cell.mix['driver']}")


def builder_of(cell: Cell):
    return importlib.import_module(f"pn2bench.builders.{cell.config['builder']}")


def reference_of(cell: Cell):
    """The plain reference's module, from its file under the benchmark's
    directory (imported by its dotted name, as the drivers' tests do)."""
    return importlib.import_module(cell.config["reference"].removesuffix(".py").replace("/", "."))


def process_start_age() -> float:
    """Seconds since this process started (its start time in /proc, in
    clock ticks since boot)."""
    import os

    ticks = os.sysconf("SC_CLK_TCK")
    start = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


class Context:
    """What a driver reads (the cell's model, mix, seed, window length,
    trace flag, the devices the cell may use, the model's builder and the
    plain reference) and how it marks the window's start."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, devices: list[torch.device]):
        self.cell, self.model, self.mix = cell, cell.config["model"], cell.mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.devices, self.device = devices, devices[0]
        self.builder, self.reference = builder_of(cell), reference_of(cell)
        self.setup_s = None
        self.first = None
        self.detail: dict = {}  # numbers reported beside the compared ones (check.train_numbers)
        self._t = time.perf_counter() - process_start_age()  # the first phase runs from the process's start

    def phase(self, name: str) -> None:
        """Standard error: the seconds a set-up phase took."""
        import sys

        now = time.perf_counter()
        print(f"setup {name} {now - self._t:.2f} s", file=sys.stderr, flush=True)
        self._t = now

    def window_started(self) -> None:
        self.setup_s = process_start_age()


@dataclasses.dataclass
class Run:
    """What a per-layer metric reads."""

    cell: str
    kind: str
    model: dict
    device: str
    out: dict  # the driver's measurements (window_s, counters, trace)
    rooflines: list

    @property
    def trace(self):
        return self.out.get("trace")


def describe_trace(tr, rooflines, capture_launches, calls) -> None:
    """Standard error: the kernels each roofline file names in the trace,
    and under a graph the port's kernels a replay ran against those its
    capture recorded (a trace that drops kernels of a replay shows here)."""
    import sys

    for op in rooflines:
        hits = [(n, e - s) for n, s, e in tr.clipped() if op.KERNELS.search(n)]
        names = sorted({(re.findall(r"::(\w+)", n) or [n[:60]])[0] for n, _ in hits})
        print(f"trace {op.__name__.split('_roofline_')[-1]}: {len(hits)} launches, "
              f"{sum(d for _, d in hits) / 1e6:.3f} ms, {names}", file=sys.stderr)
    if capture_launches and calls:
        from pn2bench import yardstick

        seen = sum(1 for n, _, _ in tr.clipped() if yardstick.kernel_class(n) == "hand-written")
        print(f"trace: {seen / calls:.1f} hand-written kernels a replay; the capture recorded "
              f"{sum(capture_launches.values())} port-kernel launches ({capture_launches})", file=sys.stderr)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices: list[torch.device]) -> dict:
    """One run of the cell on `devices` (as many as it asks for): the
    driver, then the result line's fields. `correct` needs work attempted,
    none of it failed, and every compared number within its limit."""
    ctx = Context(cell, seed, seconds, trace, devices)
    out = driver_of(cell).run(ctx)
    out["metrics"]["setup_s"] = ctx.setup_s
    used = out["devices"]
    cuda = used[0].type == "cuda"
    device_name = torch.cuda.get_device_name(used[0]) if cuda else used[0].type
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"], "metrics": {},
              "device": {"platform": "gpu" if cuda else used[0].type, "kind": device_name, "count": len(used),
                         "memory_peak_bytes": int(out["memory_peak_bytes"])}}
    if not trace:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    else:
        rooflines = [load_module(p) for p in sorted((HERE / "roofline").glob("*.py"))]
        run = Run(cell.name, out["kind"], cell.config["model"], device_name, out, rooflines)
        for m in cell.per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["trace"]
        describe_trace(tr, rooflines, out.get("capture_launches"), out.get("trace_calls"))
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    checks = {name: {"value": value, "limit": cell.limits[name]} for name, value in out["checks"].items()}
    result["correct"] = (out["attempted"] > 0 and out["failed"] == 0
                         and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    result["_ctx"] = ctx
    result["_out"] = out
    return result
