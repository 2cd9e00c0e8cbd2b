"""Run one cell of the port's benchmark once, on the card this process
finds, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload ssg.train --seed 7 --seconds 20 --trace 0

Run from the root of a checkout (BENCHMARK.json names the cells). The
program (pointnet2_scannet_tpu_torch) builds its kernels into its own
directory inside the checkout on the first run; later runs load them.
Without a card, or with fewer cards than the cell asks for, the run fails
and prints no result. After the window it fails as well if jax, jaxlib,
flax or the JAX package (pointnet2_scannet_tpu) was imported.

--trace 0 prints the cell's end-to-end metrics; --trace 1 measures the
same window, then traces a few more units of work with torch.profiler and
prints the cell's per-layer metrics, the device's busy and window seconds
and the breakdown. Every run checks what its window produced against the
plain reference (reference/), and prints each number compared with its
limit as the last lines of standard error and under "checks", last in the
result line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnet2_scannet_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (pointnet2_scannet_tpu_torch is not pointnet2_scannet_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    from pn2bench import harness

    torch.set_num_threads(4)
    devices = [torch.device("cuda", i) for i in range(chips)]
    cell = harness.find_cell(bench, args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices)
    return report(result)


def report(result: dict) -> int:
    """Print the checks and the result line; fail instead where JAX or the
    JAX package was loaded."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    result.pop("_out")
    result.pop("_ctx")
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
