#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (pointnet2_scannet_tpu_torch) once on one GPU.

    python3 chip_smoke.py

1. The card: torch's device name and nvidia-smi's name and power limit.
2. Build the five CUDA kernels from csrc/ (nvcc, sm_90a) and time the build.
3. Each forward kernel against its plain PyTorch version on the card at the
   serving path's shapes (32 columns of 8192 points, the four SSG levels):
   indices and gathers must be equal bit for bit; both times from CUDA events
   after a warm-up.
4. The scatter-add (every gather's backward) at the seven shapes of the SSG
   train step, its indices the ball-query and 3-NN outputs of phase 3: equal
   bit for bit to the plain version run on CPU copies, and to itself across
   two launches.
5. Serve synthetic scenes through scripts/infer_torch.py at SSG full width
   (xyz + color + normal, 8192-point columns, batch 32, float32) with weights
   drawn from a seeded generator: the prediction files must hold labels in
   [0, 20), every forward kernel's launch counter must have moved in that
   run, and one batch's logits must agree with the plain path on the CPU.
6. Train through scripts/train_torch.py at the same width: 32 synthetic
   scenes, batch 32, 3 epochs of one step and one validation each. Losses
   must be finite, the run dir's artifacts must exist, and all five launch
   counters must have moved in that run.
7. One train step on the card against one on the CPU (2 full-width columns,
   Dropout off): loss, gradients and BatchNorm statistics within the stated
   bounds. Two train steps on the card from one state and batch must give
   the same bits.
8. The steady-state train step at batch 32 x 8192 (forward, loss, backward,
   Adam, confusion matrix), timed with CUDA events.
9. Print one JSON line of kernel results, the card line, and last
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
# channels of the features each FP level interpolates (FP0 .. FP3)
FP_CHANNELS = (128, 256, 256, 512)
# one train step, card vs CPU: f32 summation order is the only difference.
# Loss and BatchNorm statistics are held to fixed bounds. The gradients are
# held against a float64 step on the CPU: the card's float32 gradients may be
# at most TRAIN_GRAD_VS_CPU times as far from it (per-tensor relative L2,
# worst and median tensor) as the CPU's float32 gradients are. A fixed bound
# does not hold: the train-mode BatchNorm backward below the head
# (dy - mean(dy) - x_hat * mean(dy * x_hat)) cancels most of dy, which
# magnifies float32 rounding to ~1e-3 relative on the CPU alone.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_VS_CPU = 2.0
TRAIN_BN_TOL = 1e-4


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


def check_kernels(torch) -> tuple[dict, list]:
    """Phase 3: every forward kernel vs its plain version at the path's
    shapes. Also returns the (label, idx (B, J), N, C) of every gather whose
    gradient the train step takes, from these ball-query and 3-NN outputs."""
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
    backward = []

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
        if k > 0:  # SA1 groups input data: no gradient is taken there
            backward.append((f"SA{k + 1} grouping", nidx, n_in, 3 + c))
        nn_idx = nn3.three_nn_cuda(x, q)[1].reshape(BATCH, -1)
        backward.append((f"FP{k} interpolation", nn_idx, n_out, FP_CHANNELS[k]))
    return results, backward


def check_scatter(torch, backward) -> dict:
    """Phase 4: the scatter-add kernel against its plain version on CPU
    copies (which adds in ascending j, as the kernel does) and against a
    second launch, bit for bit; times against the plain version on the card
    (unordered atomics)."""
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc

    gen = torch.Generator(device="cuda").manual_seed(1)
    r = {"module": sc, "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for label, idx, n, c in sorted(backward, key=lambda b: b[0]):
        j = idx.shape[1]
        g = torch.randn((BATCH, j, c), generator=gen, device="cuda")
        g *= 10.0 ** (torch.rand((BATCH, j, 1), generator=gen, device="cuda") * 6 - 3)
        got = sc.scatter_add_cuda(idx, g, n)
        again = sc.scatter_add_cuda(idx, g, n)
        want = sc.scatter_add_plain(idx.cpu(), g.cpu(), n)
        got = got.cpu()
        err = float((got.double() - want.double()).abs().max())
        equal = torch.equal(got, want)
        repeat = torch.equal(again.cpu(), got)
        ms = cuda_ms(lambda: sc.scatter_add_cuda(idx, g, n), torch)
        plain_ms = cuda_ms(lambda: sc.scatter_add_plain(idx, g, n), torch)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        print(f"kernel scatter_add {label} (B={BATCH}, J={j}, N={n}, C={c}): {ms:.4f} ms, "
              f"plain on the card {plain_ms:.4f} ms, max_abs_err vs CPU plain {err}, "
              f"{'equal' if equal else 'DIFFERENT'}, second launch "
              f"{'equal' if repeat else 'DIFFERENT'}", flush=True)
        if not (equal and repeat):
            raise RuntimeError(f"scatter_add {label}: kernel differs from the CPU plain version "
                               f"or from its own second launch (max_abs_err {err})")
    return {sc.NAME: r}


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

    infer_torch = load_script("infer_torch")
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
    # serving runs under inference_mode: every kernel but the backward's
    missing = [k for k, n in launches.items() if n == 0 and k != "scatter_add"]
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


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_cli(torch, tmp: pathlib.Path) -> dict:
    """Phase 6: training through scripts/train_torch.py, through the kernels."""
    import math

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    train_torch = load_script("train_torch")
    args = train_torch.parse_args([
        "--synthetic", "--synthetic_scenes", str(BATCH), "--batch_size", str(BATCH),
        "--epoch", "3", "--npoints", str(NPOINTS), "--use_color", "--use_normal",
        "--verbose", "1", "--device", "cuda", "--tag", "chip_smoke",
        "--output_root", str(tmp / "train"),
    ])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_dir, best = train_torch.train(args)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: launches {launches}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the training run launched no {missing} kernel")
    for name in ("model_best.pt", "model_last.pt", "config.json", "best.txt",
                 "model_last.train.pt", "tensorboard/all_scalars.json"):
        if not (run_dir / name).is_file():
            raise RuntimeError(f"the training run wrote no {name}")
    scalars = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    losses = [v for _, v in scalars["train/loss"]] + [v for _, v in scalars["val/loss"]]
    if len(scalars["train/loss"]) != 3 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train/val losses {losses}: not 3 epochs of finite values")
    print(f"train: 3 steps of {BATCH} x {NPOINTS} and 3 validations in {took:.2f} s; losses "
          f"{losses}; best val voxel mIoU {best['voxel_miou']:.4f}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    return {"launches": launches, "peak_gib": peak}


def train_batch(torch, n: int, device):
    """A train batch of n full-width chunks of synthetic scenes, on device."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import make_synthetic_store
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.data.pipeline import BatchLoader, to_device

    cfg = DataConfig(npoints=NPOINTS, use_color=True, use_normal=True)
    ds = ChunkedSceneDataset(make_synthetic_store(n, seed=0), cfg, phase="train", seed=0)
    ds.generate_chunks()
    return to_device(next(iter(BatchLoader(ds, n, drop_last=True))), device)


def fresh_state(torch, dropout: float, device, seed: int = 0):
    """A train state over a seeded SSG model at full width."""
    import dataclasses

    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, ssg_spec

    spec = dataclasses.replace(ssg_spec(20, 6), dropout=dropout)
    model = PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(seed), device=device)
    return ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=seed)


def grad_errors(got: dict, want: dict) -> list:
    """Per-tensor relative L2 error of gradients, sorted, worst first."""
    return sorted(((float((got[k].double() - w).norm() / w.norm()), k) for k, w in want.items()),
                  reverse=True)


def train_step_card_vs_cpu(torch) -> None:
    """Phase 7a: one train step from the same weights on the card and on the
    CPU (float32 both, and float64 on the CPU as the reference), Dropout
    off."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        state = fresh_state(torch, 0.0, device)
        state.model.to(dtype)
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in train_batch(torch, 2, device).items()}
        res = ts.train_step(state, batch, num_classes=20)
        m = state.model
        out[(device, dtype)] = (
            float(res["loss"]), {k: p.grad.cpu() for k, p in m.named_parameters()},
            {k: b.cpu() for k, b in m.named_buffers() if b.is_floating_point()},
        )
    ref = out[("cpu", torch.float64)][1]
    (cpu_loss, cpu_g, cpu_b), (gpu_loss, gpu_g, gpu_b) = (
        out[("cpu", torch.float32)], out[("cuda", torch.float32)])
    direct, card, cpu = grad_errors(gpu_g, cpu_g), grad_errors(gpu_g, ref), grad_errors(cpu_g, ref)
    med = len(card) // 2
    bn_err = max(float((gpu_b[k] - b).abs().max()) for k, b in cpu_b.items())
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"train step card vs CPU (2 x {NPOINTS}): loss {gpu_loss} vs {cpu_loss} (rel "
          f"{loss_err:.2e}); BatchNorm stats max abs err {bn_err:.2e}; gradients, per-tensor "
          f"relative L2 over {len(card)} tensors, worst / median: card vs CPU float32 "
          f"{direct[0][0]:.2e} ({direct[0][1]}) / {direct[med][0]:.2e}; vs CPU float64: card "
          f"{card[0][0]:.2e} ({card[0][1]}) / {card[med][0]:.2e}, CPU float32 {cpu[0][0]:.2e} "
          f"({cpu[0][1]}) / {cpu[med][0]:.2e}", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise RuntimeError("train step: the card's loss disagrees with the CPU's")
    if not (card[0][0] <= TRAIN_GRAD_VS_CPU * cpu[0][0]
            and card[med][0] <= TRAIN_GRAD_VS_CPU * cpu[med][0]):
        raise RuntimeError("train step: the card's gradients are further from the float64 "
                           "reference than the CPU's float32 gradients allow")
    for k, b in cpu_b.items():
        torch.testing.assert_close(gpu_b[k], b, rtol=TRAIN_BN_TOL, atol=TRAIN_BN_TOL)


def train_step_repeat_and_time(torch) -> dict:
    """Phase 7b and 8: two identical steps on the card give the same bits;
    then the warm step at batch 32, timed with CUDA events."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    batch = train_batch(torch, BATCH, "cuda")
    states = []
    for _ in range(2):
        state = fresh_state(torch, 0.5, "cuda")
        ts.train_step(state, batch, num_classes=20)
        states.append(state.model.state_dict())
    differ = [k for k, v in states[0].items() if not torch.equal(states[1][k], v)]
    print(f"train step determinism (B={BATCH}, Dropout 0.5): {len(states[0])} tensors, "
          f"{len(differ)} differ", flush=True)
    if differ:
        raise RuntimeError(f"two identical train steps on the card differ in {differ[:5]}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):  # warm: allocator, cuBLAS heuristics
        ts.train_step(state, batch, num_classes=20)
    torch.cuda.synchronize()
    events = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = ts.train_step(state, batch, num_classes=20)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out["loss"])):
        raise RuntimeError("the steady-state train step's loss is not finite")
    times = sorted(s.elapsed_time(e) for s, e in events)
    ms = times[len(times) // 2]
    pps = BATCH * NPOINTS / (ms / 1e3)
    print(f"train steady state: step of {BATCH} x {NPOINTS} in {ms:.2f} ms median of "
          f"{len(times)} (min {times[0]:.2f}, max {times[-1]:.2f}): {pps:.0f} points/s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return {"ms": ms, "points_per_s": pps}


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

    kernels, backward = check_kernels(torch)
    kernels.update(check_scatter(torch, backward))
    del backward
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        stats = serve(torch, pathlib.Path(tmp))
        train = train_cli(torch, pathlib.Path(tmp))
    train_step_card_vs_cpu(torch)
    train_step_repeat_and_time(torch)

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": r["module"].SOURCE,
            "replaces": r["module"].REPLACES,
            "launches": stats["launches"][name] + train["launches"][name],
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
