"""Per-op timings of the train step's hot list, per SA and FP level, with the
PyTorch + CUDA port (the port of scripts/bench_hotops.py).

    python scripts/bench_hotops_torch.py [--msg] [--reps 20]   # the card
    python scripts/bench_hotops_torch.py --device cpu          # plain versions, small

The SSG model at B = 32 x 8192 (--msg: the MSG shapes), per level (the
tables below, copied from bench_hotops.py):
- the grouping gathers forward (d) and backward: the default backward (h's
  block route) and group_segsum's (h's card-wide sort route);
- the ball query (b) and FPS (a);
- 3-NN (i) and the interpolation forward and backward, the gather form
  (d, h: what the card runs by default) and the dense form (bench_hotops'
  interp_dense);
- the SA1 layer-1 matmul floor;
- --msg: the two-radius query (c) against two single-radius ones (b), both
  scales' grouping gathers at MSG widths, the MSG FP interpolations.

bench() times REPS calls between CUDA events after a warm-up call, each
call's whole output summed into one device scalar (the JAX harness's
full-output consumption; that reduction is inside every time). On the CPU
(--device cpu: B = 1 and every level's points cut eightfold) the host clock
times the plain versions. Prints one row a time, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench_torch  # noqa: E402

REPS = 20
B = 32

# (name, N, M, r, K, C_src) per SSG SA level; C_src = 3 + the feature
# channels entering the level (the [xyz | feats] grouping)
SA_LEVELS = [
    ("SA1", 8192, 1024, 0.1, 32, 9),
    ("SA2", 1024, 256, 0.2, 32, 67),
    ("SA3", 256, 64, 0.4, 32, 131),
    ("SA4", 64, 16, 0.8, 32, 259),
]
# FP levels: (name, n_unknown, m_known, C_known)
FP_LEVELS = [
    ("FP4", 64, 16, 512),
    ("FP3", 256, 64, 256),
    ("FP2", 1024, 256, 256),
    ("FP1", 8192, 1024, 128),
]
# MSG: per level (name, N, M, ((r1, K1), (r2, K2)), C_src)
MSG_SA_LEVELS = [
    ("SA1", 8192, 1024, ((0.05, 16), (0.1, 32)), 9),
    ("SA2", 1024, 256, ((0.1, 16), (0.2, 32)), 99),
    ("SA3", 256, 64, ((0.2, 16), (0.4, 32)), 259),
    ("SA4", 64, 16, ((0.4, 16), (0.8, 32)), 515),
]
MSG_FP_LEVELS = [
    ("FP4", 64, 16, 1024),
    ("FP3", 256, 64, 512),
    ("FP2", 1024, 256, 512),
    ("FP1", 8192, 1024, 256),
]
CPU_CUT = 8  # --device cpu: points of every level over this, at least 4


def batch(device: str) -> int:
    return B if device == "cuda" else 1


def points(n: int, device: str) -> int:
    return n if device == "cuda" else max(4, n // CPU_CUT)


def consume(out):
    """One device scalar from the whole of an op's output (a tensor or a
    tuple of them)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(o.float().sum() for o in outs if o is not None)


def bench(name: str, fn, device: str, reps: int = REPS, rows: dict | None = None) -> float:
    """ms a call of fn over reps calls, each output consumed; CUDA events
    on the card, the host clock on the CPU. Records into rows[name]."""
    import torch

    cuda = device == "cuda"
    consume(fn())  # warm-up: builds the kernels, fills the allocator's cache
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    acc = 0.0
    for _ in range(reps):
        acc = acc + consume(fn())
    if cuda:
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        ms = (time.perf_counter() - t0) * 1e3 / reps
    if not bool(torch.isfinite(torch.as_tensor(acc))):
        raise RuntimeError(f"{name}: the output is not finite")
    print(f"{name:<60} {ms:9.4f} ms", flush=True)
    if rows is not None:
        rows[name] = ms
    return ms


def setup(device: str):
    """Import the port (TF32 off) and its ops (pn2::); refuse --device
    cuda without a card."""
    import torch

    import pointnet2_scannet_tpu_torch.ops  # noqa: F401  (switches TF32 off, registers pn2::)

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    return torch


def cloud(torch, gen, b: int, n: int, device: str):
    return torch.rand((b, n, 3), generator=gen, device=device) * 1.5


def neighbours(torch, gen, b: int, n: int, m: int, k: int, device: str):
    return torch.randint(0, n, (b, m, k), generator=gen, device=device, dtype=torch.int32)


def grouping_rows(torch, ops, gen, name: str, b: int, n: int, m: int, k: int, c: int, device: str,
                  reps: int, rows: dict) -> None:
    """A grouping gather forward, and its backward by default and under
    group_segsum."""
    from pointnet2_scannet_tpu_torch.ops import neighborhood

    src = torch.randn((b, n, c), generator=gen, device=device)
    idx = neighbours(torch, gen, b, n, m, k, device)
    bench(f"{name} gather fwd (J={m * k}, N={n}, C={c})", lambda: ops.group_points(src, idx), device, reps, rows)
    for label, group in (("block", ops.group_points), ("segsum", neighborhood.group_points_segsum)):
        x = src.clone().requires_grad_(True)
        y = group(x, idx)
        g = torch.randn(y.shape, generator=gen, device=device)
        bench(f"{name} gather bwd {label}", lambda: torch.autograd.grad(y, x, g, retain_graph=True), device,
              reps, rows)


def interpolation_rows(torch, ops, gen, name: str, b: int, n: int, m: int, c: int, device: str, reps: int,
                       rows: dict, forms=("gather", "dense")) -> None:
    from pointnet2_scannet_tpu_torch.ops.interpolate import interpolation

    _, idx = ops.three_nn(cloud(torch, gen, b, n, device), cloud(torch, gen, b, m, device))
    w = torch.rand((b, n, 3), generator=gen, device=device) * 0.9 + 0.1
    w = w / w.sum(-1, keepdim=True)
    feats = torch.randn((b, m, c), generator=gen, device=device)
    for form in forms:
        fn = interpolation(form)
        bench(f"{name} interp {form} fwd (n={n}, m={m}, C={c})", lambda: fn(feats, idx, w), device, reps, rows)
        x = feats.clone().requires_grad_(True)
        y = fn(x, idx, w)
        g = torch.randn(y.shape, generator=gen, device=device)
        bench(f"{name} interp {form} bwd", lambda: torch.autograd.grad(y, x, g, retain_graph=True), device,
              reps, rows)


def main_ssg(device: str, reps: int) -> dict:
    torch = setup(device)
    from pointnet2_scannet_tpu_torch import ops

    gen = torch.Generator(device=device).manual_seed(0)
    b, rows = batch(device), {}
    print("=== grouped gather (d) fwd; bwd by default (h, block) and group_segsum (h, sort) ===")
    for name, N, M, _, K, C in SA_LEVELS:
        grouping_rows(torch, ops, gen, name, b, points(N, device), points(M, device), K, C, device, reps, rows)
    print("=== ball query (b) ===")
    for name, N, M, r, K, _ in SA_LEVELS:
        xyz = cloud(torch, gen, b, points(N, device), device)
        q = xyz[:, :points(M, device)].contiguous()
        bench(f"{name} ball_query (N={xyz.shape[1]}, M={q.shape[1]}, K={K})",
              lambda: ops.ball_query(r, K, xyz, q), device, reps, rows)
    print("=== FPS (a) ===")
    for name, N, M, _, _, _ in SA_LEVELS:
        xyz = cloud(torch, gen, b, points(N, device), device)
        m = points(M, device)
        bench(f"{name} fps (N={xyz.shape[1]} -> {m})", lambda: ops.furthest_point_sample(xyz, m), device, reps,
              rows)
    print("=== three_nn (i) + interpolation fwd / bwd ===")
    for name, n, m, C in FP_LEVELS:
        n, m = points(n, device), points(m, device)
        unk, kno = cloud(torch, gen, b, n, device), cloud(torch, gen, b, m, device)
        bench(f"{name} three_nn ({n} from {m})", lambda: ops.three_nn(unk, kno), device, reps, rows)
        interpolation_rows(torch, ops, gen, name, b, n, m, C, device, reps, rows)
    print("=== pointwise MLP matmul floor (SA1 layer 1) ===")
    h = torch.randn((b, points(1024, device), 32, 9), generator=gen, device=device)
    w1 = torch.randn((9, 32), generator=gen, device=device)
    bench(f"SA1 layer-1 matmul ({b},{h.shape[1]},32,9)@(9,32)", lambda: h @ w1, device, reps, rows)
    return rows


def main_msg(device: str, reps: int) -> dict:
    torch = setup(device)
    from pointnet2_scannet_tpu_torch import ops

    gen = torch.Generator(device=device).manual_seed(0)
    b, rows = batch(device), {}
    print("=== MSG ball query: two-radius (c) vs 2x single (b) ===")
    for name, N, M, scales, _ in MSG_SA_LEVELS:
        xyz = cloud(torch, gen, b, points(N, device), device)
        q = xyz[:, :points(M, device)].contiguous()
        radii, ks = [r for r, _ in scales], [k for _, k in scales]
        bench(f"{name} dual ball_query (N={xyz.shape[1]}, M={q.shape[1]}, K={tuple(ks)})",
              lambda: ops.ball_query_multi(radii, ks, xyz, q), device, reps, rows)
        bench(f"{name} 2x single ball_query",
              lambda: tuple(ops.ball_query(r, k, xyz, q) for r, k in zip(radii, ks)), device, reps, rows)
    print("=== MSG grouped gather fwd / bwd (both scales) ===")
    for name, N, M, scales, C in MSG_SA_LEVELS:
        for s, (_, K) in enumerate(scales):
            grouping_rows(torch, ops, gen, f"{name}s{s}", b, points(N, device), points(M, device), K, C, device,
                          reps, rows)
    print("=== MSG three_interpolate fwd / bwd ===")
    for name, n, m, C in MSG_FP_LEVELS:
        interpolation_rows(torch, ops, gen, name, b, points(n, device), points(m, device), C, device, reps, rows)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--msg", action="store_true", help="the MSG shapes")
    p.add_argument("--reps", type=int, default=None, help=f"timed calls a row (default {REPS}; 2 on the CPU)")
    args = p.parse_args(argv)
    reps = args.reps or (REPS if args.device == "cuda" else 2)
    rows = (main_msg if args.msg else main_ssg)(args.device, reps)
    out = {"bench": "hotops_msg" if args.msg else "hotops", **bench_torch.card_fields(args.device),
           "batch": batch(args.device), "reps": reps, "ms": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
