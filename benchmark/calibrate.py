"""Readings that the limits of `correct` are set from, on the card, at a
cell's own size, for several seeds in one process (limits/<cell>.json).

    python3 benchmark/calibrate.py --workload ssg.train --seeds 12 --control 3

For each seed it runs the cell as benchmark/run.py does, with a short
window, and prints the numbers that the program's run gave (the lower
readings). For the first --control seeds it also reads the cell's driver's
controls(): the reference put in the program's place, computed in the
precision below the configuration's (the control) and with each fault
planted that the driver plants, each compared with the reference as the
program is. The last line is the readings as JSON.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate.py reads the card: {args.workload} needs {chips} CUDA device(s)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    from pn2bench import harness

    devices = [torch.device("cuda", i) for i in range(chips)]
    cell = harness.find_cell(bench, args.workload)
    readings = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "program": []}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, devices)
        ctx = res["_ctx"]
        got = {k: c["value"] for k, c in res["checks"].items()}
        readings["program"].append({"seed": seed, **got, "correct": res["correct"], "worst": dict(ctx.detail)})
        line = f"seed {seed}: program {got} {ctx.detail}"
        if i < args.control:
            for name, numbers in harness.driver_of(cell).controls(ctx).items():
                readings.setdefault(name, []).append({"seed": seed, **numbers})
                line += f"; {name} {numbers}"
        print(line + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        del res, ctx
        gc.collect()
        torch.cuda.empty_cache()
    for kind in [k for k, v in readings.items() if isinstance(v, list)]:
        rows = readings[kind]
        keys = [k for k, v in rows[0].items() if k != "seed" and isinstance(v, float)]
        readings[f"{kind}_max"] = {k: max(r[k] for r in rows) for k in keys}
        readings[f"{kind}_min"] = {k: min(r[k] for r in rows) for k in keys}
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
