"""Device time of each kernel of the shared-memory scatter-add (f,
csrc/scatter_smem.cu) and of the tiled gather (e, csrc/gather_smem.cu), on
one GPU, at the shapes chip_smoke.py checks them at.

    python -m pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter

f at the MXU-gather configuration's two train-step backwards (the SA2 and
SA3 groupings of 32 synthetic 8192-point columns: ball-query indices, one
source row collecting up to a few hundred references) and at
bench_gather_torch.py's shapes (B 32, N 8192, J 32768 uniform indices, C
9/32/64); e at the same gathers forward. For each call: the longest run of
one index (the skew), the wrapper's time between CUDA events (launch cost
included), and the device time of each kernel it launches from
torch.profiler, averaged over REPS calls. Needs a CUDA device.
"""

from __future__ import annotations

import sys

REPS = 10


def level_indices(torch):
    """The SA2 and SA3 grouping indices of 32 synthetic full-width columns:
    plain FPS between levels, then the SSG ball queries."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store
    from pointnet2_scannet_tpu_torch.ops import ball_query
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel, gather_kernel

    cfg = DataConfig(npoints=8192, use_color=True, use_normal=True)
    ds = WholeSceneDataset(make_synthetic_store(2, seed=1000), cfg, seed=0)
    cols = np.concatenate([ds.get_scene(i)[0] for i in range(len(ds))])[:32]
    xyz = [torch.from_numpy(cols[..., :3]).to("cuda").contiguous()]
    for n_out in (1024, 256, 64):
        idx = fps_kernel.furthest_point_sample_plain(xyz[-1], n_out)
        xyz.append(gather_kernel.gather_plain(xyz[-1], idx).contiguous())
    return {
        "P1 SA2 grouping": (ball_query(0.2, 32, xyz[1], xyz[2]).reshape(32, -1), 1024, 67),
        "P1 SA3 grouping": (ball_query(0.4, 32, xyz[2], xyz[3]).reshape(32, -1), 256, 131),
    }


def wrapper_ms(torch, fn) -> float:
    """Mean ms a call between CUDA events over REPS back-to-back calls after
    a warm-up, launch cost included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def device_ms(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            out[name] = t / REPS / 1e3
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_scatter: no CUDA device", file=sys.stderr)
        return 1
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = level_indices(torch)
    bench = torch.randint(0, 8192, (32, 32768), generator=gen, device="cuda", dtype=torch.int32)
    for c in (9, 32, 64):
        shapes[f"bench C={c}"] = (bench, 8192, c)
    print(f"device: {torch.cuda.get_device_name(0)}")
    for label, (idx, n, c) in shapes.items():
        idx = idx.contiguous()
        b, j = idx.shape
        g = torch.randn((b, j, c), generator=gen, device="cuda")
        src = torch.randn((b, n, c), generator=gen, device="cuda")
        runs = max(int(torch.bincount(r.long(), minlength=n).max()) for r in idx)
        for what, fn in (("f", lambda: ss.scatter_smem_cuda(idx, g, n)),
                         ("e", lambda: gs.gather_smem_cuda(src, idx))):
            parts = device_ms(torch, fn)
            print(f"{what} {label} (B={b}, J={j}, N={n}, C={c}, longest run {runs}): wrapper "
                  f"{wrapper_ms(torch, fn):.4f} ms; device " + ", ".join(
                      f"{k} {v:.4f}" for k, v in parts.items()) + f"; sum {sum(parts.values()):.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
