"""Device time of each kernel of the two scatter-adds (h, csrc/scatter_add.cu;
f, csrc/scatter_smem.cu) and of the tiled gather (e, csrc/gather_smem.cu),
on one GPU, at the shapes chip_smoke.py checks them at.

    python -m pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter [h] [f] [--routes]

h at the seven backwards of the SSG train step and the ten of the MSG train
step (the grouping and interpolation gathers' gradients of 32 synthetic
8192-point columns: the ball-query and 3-NN indices the model takes, one
source row collecting up to a few hundred references), at P3's FP0 (8
columns of 32768 points) and at one row of 65535 outputs that a skewed
index row names; with --routes, each route that scatter_kernel.plan() could
take there, launched through scatter_kernel.launch. f at the MXU-gather
configuration's two train-step backwards (the SA2 and SA3 groupings) and at
bench_gather_torch.py's shapes (B 32, N 8192, J 32768 uniform indices, C
9/32/64); e at the same gathers forward. For each call: the longest run of
one index (the skew), the wrapper's time between CUDA events (launch cost
included), and the device time of each kernel it launches from
torch.profiler, averaged over REPS calls. With no kernel named, both. Needs
a CUDA device.
"""

from __future__ import annotations

import sys

REPS = 10
BATCH = 32


def level_clouds(torch, npoints: int = 8192, batch: int = BATCH) -> list:
    """xyz of the five point sets of `batch` synthetic full-width columns:
    plain FPS between levels (1024, 256, 64, 16 centroids)."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel, gather_kernel

    cfg = DataConfig(npoints=npoints, use_color=True, use_normal=True)
    ds = WholeSceneDataset(make_synthetic_store(2, seed=1000), cfg, seed=0)
    cols = np.concatenate([ds.get_scene(i)[0] for i in range(len(ds))])[:batch]
    xyz = [torch.from_numpy(cols[..., :3]).to("cuda").contiguous()]
    for n_out in (1024, 256, 64, 16):
        idx = fps_kernel.furthest_point_sample_plain(xyz[-1], n_out)
        xyz.append(gather_kernel.gather_plain(xyz[-1], idx).contiguous())
    return xyz


def train_step_backwards(torch, kind: str, xyz: list) -> dict:
    """label -> (idx (B, J), N, C) of every gather gradient of the SSG or MSG
    train step: per SA level below SA1 and per scale, the grouping of [xyz |
    features] (3 + C words) or, where the pregather gate takes layer 0 before
    the gather, its output (widths[0] words); then FP0-FP3's interpolation."""
    from pointnet2_scannet_tpu_torch import ops
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec, ssg_spec

    spec = (msg_spec if kind == "msg" else ssg_spec)(20, 6)
    model = PointNet2SemSeg(spec)
    b = xyz[0].shape[0]
    out = {}
    for k in range(1, len(spec.npoints)):
        sa, c = getattr(model, f"sa_{k}"), spec.skip_channels[k]
        x, q = xyz[k], xyz[k + 1]
        if len(spec.radii[k]) == 2:
            idxs = ops.ball_query_multi(spec.radii[k], spec.nsamples[k], x, q)
        else:
            idxs = [ops.ball_query(spec.radii[k][0], spec.nsamples[k][0], x, q)]
        for s, (idx, mlp) in enumerate(zip(idxs, sa._mlps())):
            pre = sa._pregather(torch.empty((1, 1, c)), mlp.widths)
            width = mlp.widths[0] if pre else 3 + c
            out[f"{kind.upper()} SA{k + 1} scale {s} {'pregather' if pre else 'grouping'}"] = (
                idx.reshape(b, -1), x.shape[1], width)
    for k in range(len(spec.fp_mlps)):
        c = spec.sa_out_channels[-1] if k == len(spec.fp_mlps) - 1 else spec.fp_mlps[k + 1][-1]
        idx = ops.three_nn(xyz[k], xyz[k + 1])[1]
        out[f"{kind.upper()} FP{k} interpolation"] = (idx.reshape(b, -1), xyz[k + 1].shape[1], c)
    return out


def h_shapes(torch) -> dict:
    """h's shapes: SSG's 7 and MSG's 10 train-step backwards, P3's FP0 (8 x
    32768 points) and a skewed row of 65535 outputs (B 2, J 131072, C 64:
    one output named 1000 times among uniform indices)."""
    from pointnet2_scannet_tpu_torch import ops

    xyz = level_clouds(torch)
    shapes = {**train_step_backwards(torch, "ssg", xyz), **train_step_backwards(torch, "msg", xyz)}
    p3 = level_clouds(torch, npoints=32768, batch=8)
    shapes["P3 FP0 interpolation"] = (ops.three_nn(p3[0], p3[1])[1].reshape(8, -1), 1024, 128)
    gen = torch.Generator(device="cuda").manual_seed(3)
    skew = torch.randint(0, 65535, (2, 131072), generator=gen, device="cuda", dtype=torch.int32)
    skew[:, torch.randperm(131072, generator=gen, device="cuda")[:1000]] = 4321
    shapes["N=65535 skewed row"] = (skew, 65535, 64)
    return shapes


def f_shapes(torch) -> dict:
    """f's and e's shapes: P1's SA2 and SA3 groupings (SSG's ball queries)
    and bench_gather's three."""
    from pointnet2_scannet_tpu_torch import ops

    xyz = level_clouds(torch)
    shapes = {
        "P1 SA2 grouping": (ops.ball_query(0.2, 32, xyz[1], xyz[2]).reshape(BATCH, -1), 1024, 67),
        "P1 SA3 grouping": (ops.ball_query(0.4, 32, xyz[2], xyz[3]).reshape(BATCH, -1), 256, 131),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    bench = torch.randint(0, 8192, (BATCH, 32768), generator=gen, device="cuda", dtype=torch.int32)
    for c in (9, 32, 64):
        shapes[f"bench C={c}"] = (bench, 8192, c)
    return shapes


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


def report(torch, what: str, label: str, idx, n: int, c: int, fn) -> None:
    b, j = idx.shape
    runs = max(int(torch.bincount(r.long(), minlength=n).max()) for r in idx) if j else 0
    parts = device_ms(torch, fn)
    print(f"{what} {label} (B={b}, J={j}, N={n}, C={c}, longest run {runs}): wrapper "
          f"{wrapper_ms(torch, fn):.4f} ms; device " + ", ".join(
              f"{k} {v:.4f}" for k, v in parts.items()) + f"; sum {sum(parts.values()):.4f} ms",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_scatter: no CUDA device", file=sys.stderr)
        return 1
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    kernels = [a for a in sys.argv[1:] if a in ("h", "f")] or ["h", "f"]
    routes = "--routes" in sys.argv[1:]
    print(f"device: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "h" in kernels:
        for label, (idx, n, c) in h_shapes(torch).items():
            idx = idx.contiguous()
            b, j = idx.shape
            if n > sc.MAX_N:
                print(f"h {label}: N={n} is past h's limit of {sc.MAX_N}", flush=True)
                continue
            g = torch.randn((b, j, c), generator=gen, device="cuda")
            report(torch, "h", label, idx, n, c, lambda: sc.scatter_add_cuda(idx, g, n))
            if routes:
                for p in sc.candidate_plans(b, n, j, c, build.sm_count(g)):
                    report(torch, f"h route {type(p).__name__}{tuple(p)}", label, idx, n, c,
                           lambda p=p: sc.launch(idx, g, n, p))
    if "f" in kernels:
        for label, (idx, n, c) in f_shapes(torch).items():
            idx = idx.contiguous()
            b, j = idx.shape
            g = torch.randn((b, j, c), generator=gen, device="cuda")
            src = torch.randn((b, n, c), generator=gen, device="cuda")
            report(torch, "f", label, idx, n, c, lambda: ss.scatter_smem_cuda(idx, g, n))
            report(torch, "e", label, idx, n, c, lambda: gs.gather_smem_cuda(src, idx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
