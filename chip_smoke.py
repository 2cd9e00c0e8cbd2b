#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (pointnet2_scannet_tpu_torch) once on one GPU.

    python3 chip_smoke.py

1. The card: torch's device name and nvidia-smi's name and power limit.
2. Build the four CUDA kernels from csrc/ (nvcc, sm_90a) and time the build.
3. Each kernel against its plain PyTorch version on the card at the serving
   path's shapes (32 columns of 8192 points, the four SSG levels): indices and
   gathers must be equal bit for bit; both times from CUDA events after a
   warm-up.
4. Serve synthetic scenes through scripts/infer_torch.py at SSG full width
   (xyz + color + normal, 8192-point columns, batch 32, float32) with weights
   drawn from a seeded generator: the prediction files must hold labels in
   [0, 20), every kernel's launch counter must have moved in that run, and
   one batch's logits must agree with the plain path on the CPU.
5. Print one JSON line of kernel results, the card line, and last
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; so does a run without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
BATCH = 32
NPOINTS = 8192
NSAMPLE = 32
# (points in, points out, radius, channels grouped beside xyz) per SSG level
LEVELS = ((8192, 1024, 0.1, 6), (1024, 256, 0.2, 64), (256, 64, 0.4, 128), (64, 16, 0.8, 256))
# logits of the card vs the CPU: f32 matmuls sum in another order in cuBLAS
# and in the CPU BLAS; every index the ops produce is identical
LOGIT_RTOL = LOGIT_ATOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, torch) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up, over
    enough calls to fill about 0.2 s."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serving_columns(n_scenes: int):
    """Whole-scene columns of the synthetic scenes the serving run uses."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store

    cfg = DataConfig(npoints=NPOINTS, use_color=True, use_normal=True)
    ds = WholeSceneDataset(make_synthetic_store(n_scenes, seed=1000), cfg, seed=0)
    import numpy as np

    return np.concatenate([ds.get_scene(i)[0] for i in range(len(ds))])


def check_kernels(torch) -> dict:
    """Phase 3: every kernel vs its plain version at the path's shapes."""
    from pointnet2_scannet_tpu_torch.ops.cuda import (
        ball_query_kernel as bq,
        fps_kernel as fps,
        gather_kernel as ga,
        three_nn_kernel as nn3,
    )

    cols = serving_columns(2)
    if len(cols) < BATCH:
        raise RuntimeError(f"only {len(cols)} columns for a batch of {BATCH}")
    dev = torch.device("cuda")
    cols = torch.from_numpy(cols[:BATCH]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    xyz = [cols[..., :3].contiguous()]
    feats = [cols[..., 3:].contiguous()]
    fps_idx = []
    for n_in, n_out, _, _ in LEVELS:  # level inputs from the plain versions
        idx = fps.furthest_point_sample_plain(xyz[-1], n_out)
        fps_idx.append(idx)
        xyz.append(ga.gather_plain(xyz[-1], idx).contiguous())
    for _, _, _, c in LEVELS[1:]:
        feats.append(torch.randn((BATCH, xyz[len(feats)].shape[1], c), generator=gen, device=dev))

    results = {m.NAME: {"module": m, "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
               for m in (fps, bq, ga, nn3)}

    def compare(mod, label, kernel_fn, plain_fn):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
        equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        ms, plain_ms = cuda_ms(kernel_fn, torch), cuda_ms(plain_fn, torch)
        r = results[mod.NAME]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        print(f"kernel {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"max_abs_err {err}, {'equal' if equal else 'DIFFERENT'}", flush=True)
        if not equal:
            raise RuntimeError(f"{label}: kernel and plain version differ (max_abs_err {err})")

    for k, (n_in, n_out, radius, c) in enumerate(LEVELS):
        x, q = xyz[k], xyz[k + 1]
        compare(fps, f"fps {n_in}->{n_out}",
                lambda: fps.furthest_point_sample_cuda(x, n_out),
                lambda: fps.furthest_point_sample_plain(x, n_out))
        compare(ga, f"gather centroids ({BATCH},{n_in},3)x{n_out}",
                lambda: ga.gather_cuda(x, fps_idx[k]),
                lambda: ga.gather_plain(x, fps_idx[k]))
        compare(bq, f"ball_query r={radius} N={n_in} M={n_out} ns={NSAMPLE}",
                lambda: bq.ball_query_cuda(radius, NSAMPLE, x, q),
                lambda: bq.ball_query_plain(radius, NSAMPLE, x, q))
        nidx = bq.ball_query_cuda(radius, NSAMPLE, x, q).reshape(BATCH, -1)
        src = torch.cat([x, feats[k]], dim=-1).contiguous()
        compare(ga, f"gather grouping ({BATCH},{n_in},{3 + c})x{nidx.shape[1]}",
                lambda: ga.gather_cuda(src, nidx),
                lambda: ga.gather_plain(src, nidx))
        compare(nn3, f"three_nn n={n_in} m={n_out}",
                lambda: nn3.three_nn_cuda(x, q),
                lambda: nn3.three_nn_plain(x, q))
    return results


def serve(torch, tmp: pathlib.Path) -> dict:
    """Phase 4: the serving path end to end, through the kernels."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig, RunConfig
    from pointnet2_scannet_tpu_torch.engine.checkpoint import save_state_dict
    from pointnet2_scannet_tpu_torch.engine.export import Predictor
    from pointnet2_scannet_tpu_torch.models import get_model
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    run = tmp / "run"
    run.mkdir()
    RunConfig(
        tag="chip_smoke",
        data=DataConfig(npoints=NPOINTS, use_color=True, use_normal=True),
    ).save(run / "config.json")
    model = get_model(20, is_msg=False, input_channels=6,
                      generator=torch.Generator().manual_seed(0))
    save_state_dict(run, "model_best", model.state_dict())

    spec = importlib.util.spec_from_file_location("infer_torch", ROOT / "scripts" / "infer_torch.py")
    infer_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(infer_torch)
    args = infer_torch.parse_args([
        "--folder", str(run), "--device", "cuda", "--synthetic",
        "--synthetic_scenes", "4", "--batch_size", str(BATCH), "--out", str(tmp / "out"),
    ])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    stats = infer_torch.infer(args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"serve: launches {launches}", flush=True)
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the serving run launched no {missing} kernel")

    files = sorted((tmp / "out").glob("*_pred.npy"))
    if len(files) != 4:
        raise RuntimeError(f"expected 4 prediction files, found {len(files)}")
    for f in files:
        pred = np.load(f)
        labels = pred[:, 3]
        if pred.ndim != 2 or pred.shape[1] != 4 or not np.isfinite(pred).all():
            raise RuntimeError(f"{f.name}: bad prediction array {pred.shape}")
        if labels.min() < 0 or labels.max() >= 20 or not np.all(labels == np.round(labels)):
            raise RuntimeError(f"{f.name}: labels outside [0, 20)")
    print(f"serve: {stats['scenes']} scenes, {stats['columns']} columns, "
          f"{stats['points']} points; predict {stats['predict_s']:.3f} s, "
          f"end to end {stats['total_s']:.3f} s; peak device memory "
          f"{stats['peak_gib']:.2f} GiB", flush=True)

    batch = serving_columns(2)[:BATCH]
    gpu = Predictor.from_run(run, batch_size=BATCH, emit="logits", device="cuda")
    cpu = Predictor.from_run(run, batch_size=BATCH, emit="logits", device="cpu")
    got, want = gpu.predict(batch), cpu.predict(batch)
    err = float(np.abs(got - want).max())
    print(f"logits: card vs CPU plain path over {batch.shape}: max_abs_err {err} "
          f"(max |logit| {float(np.abs(want).max())})", flush=True)
    if got.shape != (len(batch), NPOINTS, 20) or not np.isfinite(got).all():
        raise RuntimeError(f"logits of shape {got.shape} or not finite")
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)

    labels = Predictor.from_run(run, batch_size=BATCH, device="cuda")
    labels.predict(batch)  # warm-up
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        labels.predict(batch)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    stats["steady_columns_per_s"] = len(batch) / dt
    stats["steady_points_per_s"] = len(batch) * NPOINTS / dt
    print(f"serve steady state: batch of {len(batch)} columns in {dt * 1e3:.2f} ms median of "
          f"{len(times)} (min {times[0] * 1e3:.2f}, max {times[-1] * 1e3:.2f}): "
          f"{stats['steady_columns_per_s']:.1f} columns/s, "
          f"{stats['steady_points_per_s']:.0f} points/s; serving run "
          f"{stats['columns'] / stats['predict_s']:.1f} columns/s "
          f"{stats['points'] / stats['predict_s']:.0f} points/s in predict, "
          f"{stats['columns'] / stats['total_s']:.1f} columns/s end to end", flush=True)
    stats["launches"] = launches
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import pointnet2_scannet_tpu_torch  # noqa: F401  (switches TF32 off)
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {card}", flush=True)

    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    nvcc = f"{build.build_seconds:.1f} s in nvcc" if build.build_seconds is not None else "already built"
    print(f"build: {took:.1f} s ({nvcc}) -> {build.library_path().name}", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "entry function" in line:
            print(f"  {line.strip()}")

    kernels = check_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        stats = serve(torch, pathlib.Path(tmp))

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": r["module"].SOURCE,
            "replaces": r["module"].REPLACES,
            "launches": stats["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        }
        for name, r in kernels.items()
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
