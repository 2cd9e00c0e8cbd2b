"""Where the device time of the port goes, on one GPU (pointnet2_scannet_tpu_torch).

For the SSG or MSG model at full width (32 columns x 8192 points x 9
channels, seeded random weights, float32 or with --dtype bfloat16 the
bfloat16 compute dtype), time the steady serving forward (eager, and the
same forward exported with torch.export on the card and run from its
program) and the steady train step with CUDA events, then trace a few of each with
torch.profiler and print: the device time of the top ATen ops (their kernels
included), device time by kernel class (the port's hand-written kernels,
GEMM, reductions, elementwise, other), the number of kernel launches, and the
device's busy time; its idle share of the profiled window, and of the
unprofiled call (busy time against the CUDA-event time).

  python scripts/profile_torch.py --model msg
  python scripts/profile_torch.py --model ssg
  python scripts/profile_torch.py --model ssg --dtype bfloat16

Needs a CUDA device. The profiler slows the many small launches of an eager
step, so its window is longer than the unprofiled step; both are printed.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

BATCH, NPOINTS = 32, 8192
STEPS = 3  # profiled calls of each
TOP = 20  # ops listed

# kernel-name fragments of each class, tried in this order (the hand-written
# kernels by their names in csrc/)
_CLASSES = (
    ("hand-written", ("p2_", "fps_kernel", "fps_cluster_kernel", "ball_query", "gather_kernel",
                      "three_nn_kernel", "segment_sum_kernel", "block_kernel", "tile_count_kernel",
                      "tile_prefix_kernel", "row_scan_kernel", "place_kernel", "accumulate_kernel",
                      "fixed_kernel", "general_kernel")),
    ("GEMM", ("gemm", "sgemm", "cutlass", "cublas", "xmma", "sm90_")),
    ("reduction", ("reduce", "Reduce", "scan", "Scan", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
)


def kernel_class(name: str) -> str:
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def inputs(torch, kind: str, dtype=None):
    """A seeded model (compute dtype dtype; None: float32) and one
    full-width train batch of synthetic chunks."""
    import dataclasses

    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import make_synthetic_store
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.data.pipeline import BatchLoader, to_device
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec, ssg_spec

    spec = dataclasses.replace((msg_spec if kind == "msg" else ssg_spec)(20, 6), dropout=0.5)
    model = PointNet2SemSeg(spec, dtype=dtype, generator=torch.Generator().manual_seed(0), device="cuda")
    cfg = DataConfig(npoints=NPOINTS, use_color=True, use_normal=True)
    ds = ChunkedSceneDataset(make_synthetic_store(BATCH, seed=0), cfg, phase="train", seed=0)
    ds.generate_chunks()
    return model, to_device(next(iter(BatchLoader(ds, BATCH, drop_last=True))), "cuda")


def event_ms(torch, fn, reps: int) -> list[float]:
    """ms of each of `reps` calls of fn after 3 warm calls, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)


def profile(torch, label: str, fn, call_ms: float, steps: int = STEPS) -> None:
    """Trace `steps` calls of fn and print where the device time went;
    call_ms is the unprofiled call's time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()  # the profiler's own start-up, kept out of the traced window
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_class: dict[str, float] = {}
    for e in kernels:
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + e.time_range.elapsed_us() / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for s, t in spans:  # the union of kernel intervals
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    window = (spans[-1][1] - spans[0][0]) / 1e3
    print(f"{label}: {steps} profiled calls in {wall_ms:.1f} ms wall ({wall_ms / steps:.2f} ms a "
          f"call with the profiler on); {len(kernels) / steps:.0f} kernel launches a call; device "
          f"busy {busy / 1e3 / steps:.2f} ms a call, idle share {1 - busy / 1e3 / window:.3f} of "
          f"the {window:.1f} ms from first kernel to last; without the profiler the call "
          f"takes {call_ms:.2f} ms, idle share {1 - busy / 1e3 / steps / call_ms:.3f}", flush=True)
    print(f"{label}: device ms a call by kernel class: " + ", ".join(
        f"{c} {t / steps:.2f}" for c, t in sorted(by_class.items(), key=lambda kv: -kv[1])))
    ops = [a for a in prof.key_averages() if a.key.startswith("aten::") or kernel_class(a.key) ==
           "hand-written"]
    ops.sort(key=lambda a: -a.device_time_total)
    print(f"{label}: top ops by device ms a call (their kernels included):")
    for a in ops[:TOP]:
        print(f"  {a.key:48s} {a.device_time_total / 1e3 / steps:8.3f} ms  {a.count / steps:6.0f} calls")


def main(argv=None) -> None:
    import torch

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=("ssg", "msg"), default="msg")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the compute dtype (bfloat16: float32 parameters, bfloat16 MLPs and grouping)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch.py measures the card: no CUDA device here")

    import pointnet2_scannet_tpu_torch  # noqa: F401  (switches TF32 off)
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.export import export_forward

    print(f"device: {torch.cuda.get_device_name(0)}; model {args.model.upper()}, "
          f"{BATCH} x {NPOINTS}, compute dtype {args.dtype}", flush=True)
    model, batch = inputs(torch, args.model, torch.bfloat16 if args.dtype == "bfloat16" else None)

    def forward():
        with torch.inference_mode():
            return model(batch["points"]).argmax(-1)

    model.eval()
    program = export_forward(model, batch_size=BATCH, npoints=NPOINTS, channels=9, emit="logits",
                             platforms=["cuda"]).program.module()

    def exported_forward():
        with torch.inference_mode():
            return program(batch["points"]).argmax(-1)

    for label, fn in (("serve forward", forward), ("exported serve forward", exported_forward)):
        times = event_ms(torch, fn, 10)
        print(f"{label} (labels on the card): {times[len(times) // 2]:.2f} ms median of 10 "
              f"(min {times[0]:.2f}, max {times[-1]:.2f})", flush=True)
        profile(torch, label, fn, times[len(times) // 2])

    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=0)
    step = lambda: ts.train_step(state, batch, num_classes=20)  # noqa: E731
    times = event_ms(torch, step, 10)
    print(f"train step: {times[len(times) // 2]:.2f} ms median of 10 (min {times[0]:.2f}, "
          f"max {times[-1]:.2f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile(torch, "train step", step, times[len(times) // 2])


if __name__ == "__main__":
    main()
