"""Device time of each kernel of the two scatter-adds (h, csrc/scatter_add.cu;
f, csrc/scatter_smem.cu), of the tiled gather (e, csrc/gather_smem.cu), of
the row gather (d, csrc/gather.cu), of FPS (a, csrc/fps.cu), of 3-NN (i,
csrc/three_nn.cu; j, the query-major route, runs it too) and of the ball
queries (b, csrc/ball_query.cu; c, csrc/ball_query_multi.cu) and of the
fused gather-matmul (k, csrc/fused_gather_mm.cu), on one GPU, at the shapes
chip_smoke.py checks them at.

    python -m pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter [h] [f] [d] [a] [probe_a] [i] [b] [c] [j] [k] [host] [serve] [ptxas] [--routes]

h at the seven backwards of the SSG train step and the ten of the MSG train
step (the grouping and interpolation gathers' gradients of 32 synthetic
8192-point columns: the ball-query and 3-NN indices the model takes, one
source row collecting up to a few hundred references), at P3's FP0 (8
columns of 32768 points) and at one row of 65535 outputs that a skewed
index row names; with --routes, each route that scatter_kernel.plan() could
take there, launched through scatter_kernel.launch. f at the MXU-gather
configuration's two train-step backwards (the SA2 and SA3 groupings) and at
bench_gather_torch.py's shapes (B 32, N 8192, J 32768 uniform indices, C
9/32/64); e at the same gathers forward; both again on bfloat16 rows (f's
tile-by-tile sum, e's int32 pairs or 2-byte words). ptxas: the registers
ptxas reported for e's, f's, h's and a's kernels, building the library in this
process (run it as a file with PYTHONPATH=<an older checkout> to read that
checkout's). For each call: the longest run of
one index (the skew), the wrapper's time between CUDA events (launch cost
included), and the device time of each kernel it launches from
torch.profiler, averaged over REPS calls. d at SSG's 8 gathers (the four
levels' centroids and groupings), SSG's 4 FP interpolation gathers and
MSG's 16 (listed from the MSG model as chip_smoke.py lists them): d's
device and wrapper time beside torch.gather's device time on an int64
index made beforehand, and with --routes every words-a-thread choice of
gather_kernel.plan(). a at SSG's four levels, P3's (8, 32768) -> 1024,
(8, 20000) -> 1024 and -> 2048 (VoteNet's SA1), (2, 32768) float64 and
the limits (1, 131072) float32 and (1, 65536) float64, with (8, 16384)
and P3 at B 32: wrapper and device time, µs a step, fps_kernel.plan()'s
launch and the clusters the card holds at once, with --routes every
candidate_plans() launch from 8192 points up.
probe_a: the probes of csrc/fps_probe.cu at SA1's shape (the time a step of
each part of a step; kind 6 at the cluster kernel's sizes) and the registers
and spills ptxas reported for the FPS kernels (also under ptxas). i at SSG's
four FP levels (32 columns: (n, m) = (8192, 1024), (1024, 256), (256, 64),
(64, 16)) and P3's FP0 (8, 32768, 1024); b at SSG's four SA levels (radii
0.1-0.8, 32 samples) and P3's SA1 (8, 32768 -> 1024, r 0.1), i's levels
beside their insertion statistics (a query's top-3 insertions, and the
share of known points at which some lane of a warp inserts), b's beside
their scan statistics (the mean share of the row a query scans up to
its 32nd hit; the pairs tested if groups of G consecutive queries scanned
as long as their longest member, over the pairs scanned, at G = 4, 8, 32);
for both the wrapper and device ms, the plan where the module has one
(with --routes every launch shape it could take) and ptxas' registers. c
(the two-radius ball query, csrc/ball_query_multi.cu) at MSG's four levels
(radii 0.05/0.1 to 0.4/0.8, 16 and 32 samples) beside two launches of b,
with each radius's scan share; j (the query-major 3-NN) at FP0 of
7936-point columns, at n = m = 8192 and at one row of 256 queries against
8192 known points, beside i with i's insertion statistics. k (the fused
gather-matmul, csrc/fused_gather_mm.cu) at scripts/bench_fused_sa.py's
shape (B 32, N 8192, J 32768, C 9, F 32): device, wrapper and host time,
bytes a second against the bound, beside the unfused composition (d, then
torch.matmul) and d alone, with --routes every launch its plan() could
take, ptxas' registers and the innermost loops of its SASS (cuobjdump).
host: the host µs of each piece of d's, a's, i's, b's, c's, j's and h's wrappers at SA4's
and FP3's shapes, and of the public ops that call them (under
torch.inference_mode, as serving calls them; through the pn2:: torch.library
ops where the checkout has them, ops/library.py, each op also alone). serve:
the eager Predictor's steady batch of 32 x 8192 (SSG and MSG, float32,
random weights from seed 0, labels back on the host, median of 9 after a
warm call) and, where the checkout has artifacts, the same batch served from
a torch.export artifact traced on the card (ServingPredictor), the two in
turns. With no kernel named, h and f.
Needs a CUDA device.
"""

from __future__ import annotations

import sys

REPS = 10
BATCH = 32


def synthetic_columns(torch, npoints: int, batch: int):
    """xyz (batch, npoints, 3) on the card of synthetic full-width columns."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store

    cfg = DataConfig(npoints=npoints, use_color=True, use_normal=True)
    ds = WholeSceneDataset(make_synthetic_store(2, seed=1000), cfg, seed=0)
    cols = np.concatenate([ds.get_scene(i)[0] for i in range(len(ds))])[:batch]
    return torch.from_numpy(cols[..., :3]).to("cuda").contiguous()


def level_clouds(torch, npoints: int = 8192, batch: int = BATCH) -> list:
    """xyz of the five point sets of `batch` synthetic full-width columns:
    plain FPS between levels (1024, 256, 64, 16 centroids)."""
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel, gather_kernel

    xyz = [synthetic_columns(torch, npoints, batch)]
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


def d_shapes(torch) -> dict:
    """d's shape sets: label -> (src (B, N, C), idx (B, J)); SSG's 8 gathers,
    SSG's 4 FP interpolation gathers, MSG's 16."""
    from pointnet2_scannet_tpu_torch import ops
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel

    xyz = level_clouds(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(n, c):
        return torch.randn((BATCH, n, c), generator=gen, device="cuda")

    sets = {"SSG 8": {}, "SSG FP 4": {}, "MSG 16": {}}
    for k, (radius, c, fp) in enumerate(zip((0.1, 0.2, 0.4, 0.8), (6, 64, 128, 256),
                                            (128, 256, 256, 512))):
        x, q = xyz[k], xyz[k + 1]
        n, m = x.shape[1], q.shape[1]
        centroids = fps_kernel.furthest_point_sample_plain(x, m)
        sets["SSG 8"][f"SA{k + 1} centroids ({BATCH},{n},3)x{m}"] = (x, centroids)
        idx = ops.ball_query(radius, 32, x, q).reshape(BATCH, -1)
        sets["SSG 8"][f"SA{k + 1} grouping ({BATCH},{n},{3 + c})x{idx.shape[1]}"] = (
            torch.cat([x, rand(n, c)], dim=-1).contiguous(), idx)
        nn = ops.three_nn(x, q)[1].reshape(BATCH, -1)
        sets["SSG FP 4"][f"FP{k} ({BATCH},{m},{fp})x{nn.shape[1]}"] = (rand(m, fp), nn)
    spec = msg_spec(20, 6)
    model = PointNet2SemSeg(spec)
    for k in range(len(spec.npoints)):
        sa, c, x = getattr(model, f"sa_{k}"), spec.skip_channels[k], xyz[k]
        n = x.shape[1]
        idxs = ops.ball_query_multi(spec.radii[k], spec.nsamples[k], x, xyz[k + 1])
        for s, (idx, mlp) in enumerate(zip(idxs, sa._mlps())):
            idx = idx.reshape(BATCH, -1)
            if sa._pregather(torch.empty((1, 1, c)), mlp.widths):
                srcs = {"pregather zf": rand(n, mlp.widths[0]), "pregather xyz": x}
            else:
                srcs = {"grouping": torch.cat([x, rand(n, c)], dim=-1).contiguous()}
            for what, src in srcs.items():
                sets["MSG 16"][f"SA{k + 1} scale {s} {what} ({BATCH},{n},{src.shape[2]})x{idx.shape[1]}"] = (
                    src, idx)
    for k in range(len(spec.fp_mlps)):
        c = spec.sa_out_channels[-1] if k == len(spec.fp_mlps) - 1 else spec.fp_mlps[k + 1][-1]
        q = xyz[k + 1]
        nn = ops.three_nn(xyz[k], q)[1].reshape(BATCH, -1)
        sets["MSG 16"][f"FP{k} ({BATCH},{q.shape[1]},{c})x{nn.shape[1]}"] = (rand(q.shape[1], c), nn)
    return sets


def profile_d(torch, routes: bool) -> None:
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    for name, shapes in d_shapes(torch).items():
        total = {"d device": 0.0, "d wrapper": 0.0, "torch.gather device": 0.0}
        for label, (src, idx) in shapes.items():
            idx = idx.contiguous()
            index = idx.long().unsqueeze(-1).expand(-1, -1, src.shape[2])
            d_dev = sum(device_ms(torch, lambda: ga.gather_cuda(src, idx)).values())
            d_wrap = wrapper_ms(torch, lambda: ga.gather_cuda(src, idx))
            lib = sum(device_ms(torch, lambda: torch.gather(src, 1, index)).values())
            for key, v in zip(total, (d_dev, d_wrap, lib)):
                total[key] += v
            where = ""
            if hasattr(ga, "plan"):
                (b, n, c), j = src.shape, idx.shape[1]
                p = ga.plan(b, n, j, c, build.sm_count(src))
                where = f", plan {tuple(p)}"
                if routes:
                    out = torch.empty((b, j, c), dtype=src.dtype, device="cuda")
                    for vec in sorted({p.vec, 1}, reverse=True):
                        for per in (1, 2, 4, 8):
                            q = ga.Plan(vec, per, -(-b * j * (c // vec) // (per * ga.THREADS)))
                            t = sum(device_ms(torch, lambda q=q: ga.launch(src, idx, out, q)).values())
                            where += f"; {tuple(q)} {t:.4f}"
            print(f"d {name} {label}: device {d_dev:.4f} ms, wrapper {d_wrap:.4f} ms, torch.gather "
                  f"device {lib:.4f} ms{where}", flush=True)
        print(f"d {name} summed: " + ", ".join(f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)


def fps_levels(torch) -> dict:
    """label -> (xyz, centroids) of a's shapes: SSG's four levels (32
    columns), (8, 16384) -> 1024 (the largest row of one block), P3's (8,
    32768) -> 1024 and at B 32, (8, 20000) -> 1024 and VoteNet's SA1 (8,
    20000) -> 2048, (2, 32768) -> 1024 in float64, and the limits: (1,
    131072) float32 and (1, 65536) float64 -> 128."""
    xyz = level_clouds(torch)
    out = {f"SSG {x.shape[1]}->{q.shape[1]}": (x, q.shape[1]) for x, q in zip(xyz, xyz[1:])}
    p3, mid = synthetic_columns(torch, 32768, 32), synthetic_columns(torch, 20000, 8)
    out["16384->1024"] = (synthetic_columns(torch, 16384, 8), 1024)
    out["P3 32768->1024 at B 32"] = (p3, 1024)
    p3 = p3[:8].contiguous()
    out["P3 32768->1024"] = (p3, 1024)
    out["20000->1024"] = (mid, 1024)
    out["VoteNet SA1 20000->2048"] = (mid, 2048)
    out["float64 32768->1024"] = (p3[:2].double().contiguous(), 1024)
    out["limit 131072->128"] = (synthetic_columns(torch, 131072, 1), 128)
    out["float64 limit 65536->128"] = (synthetic_columns(torch, 65536, 1).double().contiguous(), 128)
    return out


def profile_a(torch, routes: bool = False) -> None:
    """a at fps_levels' shapes: device and wrapper ms, µs a step, the plan
    and, for a cluster plan, how many clusters the card holds at once (the
    waves of B clusters); with routes, every candidate_plans() launch."""
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps

    ssg = 0.0
    for label, (x, m) in fps_levels(torch).items():
        try:
            fps.furthest_point_sample_cuda(x, m)
        except ValueError as e:  # an older checkout's limit
            print(f"a {label}: {e}", flush=True)
            continue
        b, n = x.shape[:2]
        dev = sum(device_ms(torch, lambda: fps.furthest_point_sample_cuda(x, m)).values())
        wrap = wrapper_ms(torch, lambda: fps.furthest_point_sample_cuda(x, m))
        ssg += dev if label.startswith("SSG") else 0.0
        where = f", plan {tuple(fps.plan(n, x.dtype))}" if hasattr(fps, "plan") else ""
        if hasattr(fps, "resident_clusters") and fps.plan(n, x.dtype).variant == "cluster":
            held = fps.resident_clusters(n, x.dtype, x.get_device())
            where += f", {held} clusters at once ({-(-b // held)} wave(s) of B {b}; B 32: {-(-32 // held)})"
        print(f"a {label} (B={b}): device {dev:.4f} ms ({1e3 * dev / (m - 1):.3f} us a "
              f"step), wrapper {wrap:.4f} ms{where}", flush=True)
        if routes and hasattr(fps, "candidate_plans") and n >= 8192:
            for p in fps.candidate_plans(n, x.dtype):
                t = sum(device_ms(torch, lambda p=p: fps.launch(x, m, p)).values())
                print(f"a route {label} {tuple(p)}: device {t:.4f} ms ({1e3 * t / (m - 1):.3f} us a step)",
                      flush=True)
    print(f"a SSG summed: device {ssg:.4f} ms", flush=True)


def probe_a(torch) -> None:
    """The probes of csrc/fps_probe.cu at SA1's shape (kind 6, the cluster
    kernel's exchange, where the library has it, at the cluster sizes and
    block widths fps_kernel.plan() picks), and the registers and spills
    ptxas reported for the FPS kernels (where this process built the
    library)."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    lib = build.library()
    if hasattr(lib, "p2_fps_probe"):
        x = level_clouds(torch)[0]
        out = torch.empty((BATCH, 1024), dtype=torch.int32, device="cuda")
        # (kind, cluster, threads, what); kinds 6-8 at B 8 as well, where
        # every cluster of 8 blocks fits the card at once (B 32 runs 2-3 waves)
        probes = (
            (0, 1, 1024, "distance update, points in shared memory (the earlier design)"),
            (1, 1, 1024, "block reduction, shuffles and two barriers (the earlier design)"),
            (2, 2, 1024, "cluster exchange of the earlier cluster kernel, 2 blocks of 1024"),
            (2, 4, 256, "cluster exchange of the earlier cluster kernel, 4 blocks of 256"),
            (3, 1, 1024, "distance update, points in registers"),
            (4, 1, 1024, "block reduction, redux keys and one barrier"),
            (5, 2, 512, "exchange of a row split over 2 blocks of 512"),
            (5, 4, 256, "exchange of a row split over 4 blocks of 256"),
            (3, 1, 256, "distance update, points in registers, 256 threads (a 4-way split's share)"),
            (3, 1, 864, "distance update, points in registers, 864 threads ((8, 20000)'s share)"),
            (7, 1, 1024, "block reduction with the cluster barrier, 1 block of 1024"),
            *((kind, c, t, f"{name}, {c} blocks of {t}{where}") for kind, name in (
                (6, "every warp's key pushed, one cluster barrier"),
                (8, "block reduction, one key a block pushed with release, polled"),
                (9, "block reduction, one key a block pushed, one cluster barrier"),
                (10, "block reduction, one key a block by st.async, transaction barrier"))
              for c, t, where in ((1, 1024, ""), (3, 864, " ((8, 20000))"), (4, 1024, " (P3)"),
                                  (5, 1024, " (float64 20000)"), (8, 1024, " (float64 32768)"),
                                  (8, 544, " (65537)"))
              if c > 1 or kind < 9),
        )
        for kind, cluster, threads, what in probes:
            src = x[:, : threads * 8].contiguous()
            for b in (BATCH, 8) if kind >= 6 else (BATCH,):
                def run(kind=kind, cluster=cluster, threads=threads, src=src, b=b):
                    build.check(lib.p2_fps_probe(kind, build.ptr(src), b, 1024, cluster, threads,
                                                 build.ptr(out), build.stream_of(src)), "fps_probe")

                try:
                    run()
                except RuntimeError as e:  # an older library without that kind
                    print(f"a probe {kind} {what}: {e}", flush=True)
                    break
                t = sum(device_ms(torch, run).values())
                print(f"a probe {kind} {what} (B={b}, {threads * 8} points a block, 1023 steps): "
                      f"{t:.4f} ms, {1e3 * t / 1023:.3f} us a step", flush=True)
    ptxas("a", "fps")


def ptxas(what: str, *names: str) -> None:
    """The registers and spills ptxas reported for the kernels whose mangled
    name holds every one of `names` (only in the process that built the
    library)."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    lines = build.build_log.splitlines()
    if not lines:
        print(f"{what} ptxas: the library was built by an earlier process; no ptxas report here")
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and all(name in line for name in names):
            print(f"{what} ptxas: " + " | ".join(part.strip() for part in lines[k:k + 4]), flush=True)


def scan_points(torch, x, q, radius: float, k: int):
    """(B, M) points a first-k-hits scan in index order reads per query: up
    to its k-th hit, or all N."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist

    r = np.float32(radius)
    r2 = torch.tensor(r * r, device=x.device)
    out = torch.empty(q.shape[:2], dtype=torch.int64, device=x.device)
    for b in range(x.shape[0]):
        hits = (pairwise_sqdist(q[b], x[b]) < r2).cumsum(-1)
        out[b] = ((hits < k).sum(-1) + 1).clamp(max=x.shape[1])
    return out


def scan_stats(torch, x, q, radius: float, k: int) -> str:
    """The mean share of the row a query's scan reads, and the group waste:
    the pairs that groups of G consecutive queries of a batch row would test
    if each scanned as long as its longest member, over the pairs scanned."""
    scans = scan_points(torch, x, q, radius, k).double()
    out = [f"scan {float(scans.mean()) / x.shape[1]:.3f} of the row"]
    for g in (4, 8, 32):
        m = scans.shape[1] // g * g
        if m == 0:
            continue
        longest = scans[:, :m].reshape(scans.shape[0], -1, g).amax(-1)
        out.append(f"G {g} {float(longest.sum()) * g / float(scans[:, :m].sum()):.3f}x")
    return ", ".join(out)


def insertion_stats(torch, x, q) -> str:
    """How often a strict-< top-3 scan of the known points q in index order
    inserts: a query's insertions, and the share of (warp of 32 consecutive
    queries, known point) pairs at which some lane inserts."""
    from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist

    d = pairwise_sqdist(x, q)  # (B, n, m)
    (b, n, m), w = d.shape, x.shape[1] // 32 * 32
    top = torch.full((b, n, 3), float("inf"), device=x.device)
    ins = torch.empty((b, n, m), dtype=torch.bool, device=x.device)
    for k in range(m):
        col = d[..., k]
        ins[..., k] = col < top[..., 2]
        merged = torch.cat([top, col[..., None]], -1).sort(-1).values[..., :3]
        top = torch.where(ins[..., k, None], merged, top)
    warp = ins[:, :w].reshape(b, -1, 32, m).any(2).float().mean() if w else float("nan")
    return f"{float(ins.sum(-1).float().mean()):.1f} insertions a query, a warp's {float(warp):.3f}"


def profile_i(torch, routes: bool) -> None:
    """i at SSG's FP levels and P3's FP0: device and wrapper ms, the plan."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3

    xyz = level_clouds(torch)
    shapes = {f"SSG FP{k}": (xyz[k], xyz[k + 1]) for k in range(4)}
    p3 = level_clouds(torch, npoints=32768, batch=8)
    shapes["P3 FP0"] = (p3[0], p3[1])
    total = {"device": 0.0, "wrapper": 0.0}
    for label, (x, q) in shapes.items():
        (b, n, _), m = x.shape, q.shape[1]
        dev = sum(device_ms(torch, lambda: nn3.three_nn_cuda(x, q)).values())
        wrap = wrapper_ms(torch, lambda: nn3.three_nn_cuda(x, q))
        if label.startswith("SSG"):
            total["device"] += dev
            total["wrapper"] += wrap
        where = ""
        if hasattr(nn3, "plan"):
            p = nn3.plan(b, n, m, build.sm_count(x))
            where = f", plan {tuple(p)}"
            if routes:
                dist2 = torch.empty((b, n, 3), device="cuda")
                idx = torch.empty((b, n, 3), dtype=torch.int32, device="cuda")
                for c in nn3.candidate_plans(b, n, m):
                    t = sum(device_ms(torch, lambda c=c: nn3.launch(x, q, dist2, idx, c)).values())
                    where += f"; {tuple(c)} {t:.4f}"
        print(f"i {label} (B={b}, n={n}, m={m}; {insertion_stats(torch, x, q)}): device {dev:.4f} ms, "
              f"wrapper {wrap:.4f} ms{where}", flush=True)
    print("i SSG summed: " + ", ".join(f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    ptxas("i", "three_nn_kernel")


def profile_b(torch, routes: bool) -> None:
    """b at SSG's SA levels and P3's SA1: device and wrapper ms, the plan,
    the scan statistics."""
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    xyz = level_clouds(torch)
    shapes = {f"SSG SA{k + 1}": (xyz[k], xyz[k + 1], r) for k, r in enumerate((0.1, 0.2, 0.4, 0.8))}
    p3 = level_clouds(torch, npoints=32768, batch=8)
    shapes["P3 SA1"] = (p3[0], p3[1], 0.1)
    total = {"device": 0.0, "wrapper": 0.0}
    k = 32
    for label, (x, q, r) in shapes.items():
        (b, n, _), m = x.shape, q.shape[1]
        dev = sum(device_ms(torch, lambda: bq.ball_query_cuda(r, k, x, q)).values())
        wrap = wrapper_ms(torch, lambda: bq.ball_query_cuda(r, k, x, q))
        if label.startswith("SSG"):
            total["device"] += dev
            total["wrapper"] += wrap
        where = ""
        if hasattr(bq, "plan"):
            p = bq.plan(b, n, m, build.sm_count(x))
            where = f", plan {tuple(p)}"
            if routes:
                out = torch.empty((b, m, k), dtype=torch.int32, device="cuda")
                for c in bq.candidate_plans(b, n, m, build.sm_count(x)):
                    t = sum(device_ms(torch, lambda c=c: bq.launch(r, k, x, q, out, c)).values())
                    where += f"; {tuple(c)} {t:.4f}"
        print(f"b {label} (B={b}, N={n}, M={m}, r={r}, {k} samples; {scan_stats(torch, x, q, r, k)}): "
              f"device {dev:.4f} ms, wrapper {wrap:.4f} ms{where}", flush=True)
    print("b SSG summed: " + ", ".join(f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    ptxas("b", "ball_query", "ILi1E")  # ball_scan.cuh's instances for one radius


def profile_c(torch, routes: bool) -> None:
    """c at MSG's four levels: device and wrapper ms beside two launches of
    b, each radius's scan share and the longer of the two (the fused
    scan's), the plan where the module has one (with --routes every launch
    shape it could take)."""
    from pointnet2_scannet_tpu_torch.models import msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    xyz = level_clouds(torch)
    spec = msg_spec(20, 6)
    total = {"device": 0.0, "wrapper": 0.0, "two b device": 0.0, "two b wrapper": 0.0}
    for k, (radii, ks) in enumerate(zip(spec.radii, spec.nsamples)):
        x, q = xyz[k], xyz[k + 1]
        (b, n, _), m = x.shape, q.shape[1]

        def fused():
            return bqm.ball_query_multi_cuda(radii, ks, x, q)

        def two():
            return bq.ball_query_cuda(radii[0], ks[0], x, q), bq.ball_query_cuda(radii[1], ks[1], x, q)

        times = (sum(device_ms(torch, fused).values()), wrapper_ms(torch, fused),
                 sum(device_ms(torch, two).values()), wrapper_ms(torch, two))
        for key, v in zip(total, times):
            total[key] += v
        scans = [scan_points(torch, x, q, r, s).double() for r, s in zip(radii, ks)]
        share = ", ".join(f"r {r} scans {float(t.mean()) / n:.3f}" for r, t in zip(radii, scans))
        share += f", the longer {float(torch.maximum(*scans).mean()) / n:.3f} of the row"
        where = ""
        if hasattr(bqm, "plan"):
            p = bqm.plan(b, n, m, build.sm_count(x))
            where = f", plan {tuple(p)}"
            if routes:
                outs = tuple(torch.empty((b, m, s), dtype=torch.int32, device="cuda") for s in ks)
                for c in bqm.candidate_plans(b, n, m, build.sm_count(x)):
                    t = sum(device_ms(torch, lambda c=c: bqm.launch(radii, ks, x, q, outs, c)).values())
                    where += f"; {tuple(c)} {t:.4f}"
        print(f"c MSG SA{k + 1} (B={b}, N={n}, M={m}, r={radii}, {ks} samples; {share}): device "
              f"{times[0]:.4f} ms, wrapper {times[1]:.4f} ms; two b launches device {times[2]:.4f} ms, "
              f"wrapper {times[3]:.4f} ms{where}", flush=True)
    print("c MSG summed: " + ", ".join(f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    ptxas("c", "ball_query_multi_kernel")  # the earlier one-warp-a-query kernel
    ptxas("c", "ball_query", "ILi2E")  # ball_scan.cuh's instances for two radii


def profile_j(torch) -> None:
    """j at FP0 of 7936-point columns, at n = m = 8192 (another column's
    points as the known set) and at one row of 256 queries against 8192
    known points: j's device and wrapper ms beside i's, with i's insertion
    statistics."""
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_q_kernel as nnq

    xyz = level_clouds(torch)
    shapes = {
        "FP0 of 7936-point columns": (xyz[0][:, :7936].contiguous(), xyz[1]),
        "n = m = 8192": (xyz[0], xyz[0].roll(1, dims=0).contiguous()),
        "one row, 256 queries": (xyz[1][:1, :256].contiguous(), xyz[0][:1].contiguous()),
    }
    for label, (x, q) in shapes.items():
        (b, n, _), m = x.shape, q.shape[1]
        times = []
        for fn in (nnq.three_nn_q_cuda, nn3.three_nn_cuda):
            times += [sum(device_ms(torch, lambda fn=fn: fn(x, q)).values()),
                      wrapper_ms(torch, lambda fn=fn: fn(x, q))]
        print(f"j {label} (B={b}, n={n}, m={m}; {insertion_stats(torch, x, q)}; source "
              f"{nnq.SOURCE.rsplit('/', 1)[-1]}): device {times[0]:.4f} ms, wrapper {times[1]:.4f} ms; "
              f"i device {times[2]:.4f} ms, wrapper {times[3]:.4f} ms", flush=True)


K_SHAPE = (32, 8192, 32768, 9, 32)  # B, N, J, C, F: scripts/bench_fused_sa.py's


def sass_loops(what: str, *names: str, loops: int = 8) -> None:
    """Instruction counts of the kernels whose mangled name holds every one of
    `names`, from `cuobjdump -sass` of the built library: the whole kernel,
    then each loop (a span that a backward branch closes) in address order,
    with its most frequent opcodes."""
    import collections
    import pathlib
    import re
    import subprocess

    from pointnet2_scannet_tpu_torch.ops.cuda import build

    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    run = subprocess.run([str(tool), "-sass", str(build.library_path())], capture_output=True, text=True,
                         timeout=120)
    if run.returncode:
        print(f"{what} sass: cuobjdump failed ({run.stderr.strip()[-300:]})", flush=True)
        return
    text = run.stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split(None, 1)[0]
        if not all(n in name for n in names):
            continue
        insts, labels = [], {}
        for line in fn.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                labels[label.group(1)] = len(insts)
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
            if m:
                insts.append((int(m.group(1), 16), m.group(2)))
        at = {addr: k for k, (addr, _) in enumerate(insts)}
        spans = []
        for k, (_, text_) in enumerate(insts):
            op = re.sub(r"^@!?U?P\w+\s+", "", text_).split()
            if not op or not op[0].startswith("BRA"):
                continue
            hexa, label = re.search(r"0x([0-9a-f]+)", text_), re.search(r"(\.L_x_\d+)", text_)
            target = at.get(int(hexa.group(1), 16)) if hexa else labels.get(label.group(1)) if label else None
            if target is not None and target <= k:
                spans.append((target, k))

        def hist(part):
            ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for _, t in part)
            return ", ".join(f"{op} {n}" for op, n in ops.most_common(8))

        print(f"{what} sass {name[:60]}: {len(insts)} instructions ({hist(insts)})", flush=True)
        for lo, hi in sorted(set(spans))[:loops]:
            print(f"{what} sass loop [{lo}, {hi}]: {hi - lo + 1} instructions ({hist(insts[lo:hi + 1])})",
                  flush=True)


def profile_k(torch, routes: bool) -> None:
    """k at bench_fused_sa's shape: device, wrapper and host time, the bytes a
    second against the bound, the unfused counterpart (d, then torch.matmul)
    and d alone; with --routes every launch k's plan() could take; ptxas'
    registers and the SASS loops."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    b, n, j, c, f = K_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    src = torch.randn((b, n, c), generator=gen, device="cuda")
    idx = torch.randint(0, n, (b, j), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.randn((c, f), generator=gen, device="cuda") * 0.1
    s = idx.sort(dim=1).values
    rows = b + int((s[:, 1:] != s[:, :-1]).sum())
    nbytes = 4 * (rows * c + b * j + c * f + b * j * f)
    bound = nbytes / 3.35e12 * 1e3
    want = fk.fused_gather_mm_plain(src, idx, w)
    fns = {
        "k": lambda: fk.fused_gather_mm_cuda(src, idx, w),
        "d + torch.matmul": lambda: ga.gather_cuda(src, idx) @ w,
        "d alone": lambda: ga.gather_cuda(src, idx),
    }
    for label, fn in fns.items():
        dev = sum(device_ms(torch, fn).values())
        wrap = wrapper_ms(torch, fn)
        host = host_us(torch, fn, reps=200)
        more = ""
        if label == "k":
            more = (f", {nbytes / dev / 1e6:.0f} GB/s on the device ({bound / dev:.3f} of the bound "
                    f"{bound:.4f} ms), equal to plain {torch.equal(fn(), want)}")
            if hasattr(fk, "plan"):
                more += f", plan {tuple(fk.plan(b, n, j, c, f, build.sm_count(src)))}"
        print(f"k {label} (B={b}, N={n}, J={j}, C={c}, F={f}): device {dev:.4f} ms, wrapper {wrap:.4f} ms, "
              f"host {host:.2f} us a call{more}", flush=True)
    if routes and hasattr(fk, "candidate_plans"):
        out = torch.empty((b, j, f), device="cuda")
        for p in fk.candidate_plans(b, n, j, c, f, build.sm_count(src)):
            t = sum(device_ms(torch, lambda p=p: fk.launch(src, idx, w, out, p)).values())
            print(f"k route {tuple(p)}: device {t:.4f} ms, equal to plain {torch.equal(out, want)}", flush=True)
    ptxas("k", "fused_gather_mm")
    sass_loops("k", "fused_gather_mm")


def host_us(torch, fn, reps: int = 2000) -> float:
    """Host µs a call of fn over reps calls, the card synchronised before
    and after (the small launches queue faster than the card runs them)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * took / reps


def host_costs(torch) -> None:
    """The host time of the pieces of d's, a's, i's and b's wrappers at the
    deep levels' shapes (SA4's centroids, the smallest gather; SA4's FPS and
    ball query; FP3's 3-NN), beside torch.gather's whole call."""
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_q_kernel as nnq

    src = torch.randn((BATCH, 64, 3), device="cuda")
    cen = src[:, :16].contiguous()
    idx = torch.randint(0, 64, (BATCH, 16), device="cuda", dtype=torch.int32)
    index = idx.long().unsqueeze(-1).expand(-1, -1, 3)
    out = torch.empty((BATCH, 16, 3), device="cuda")
    lib = build.library()
    p = ga.plan(BATCH, 64, 16, 3, build.sm_count(src))
    pieces = {
        "build.require(src)": lambda: build.require(src, "src", (torch.float32, torch.int32), 3),
        "torch.empty(device=src.device)": lambda: torch.empty((BATCH, 16, 3), dtype=src.dtype,
                                                              device=src.device),
        "with torch.cuda.device(src.device)": lambda: torch.cuda.device(src.device).__enter__(),
        "build.stream_of": lambda: build.stream_of(src),
        "plan (cached)": lambda: ga.plan(BATCH, 64, 16, 3, build.sm_count(src)),
        "p2_gather, nothing to launch": lambda: lib.p2_gather(
            src.data_ptr(), idx.data_ptr(), 0, 64, 16, 3, 1, 1, 4, out.data_ptr(), 0, 0),
        "gather_kernel.launch": lambda: ga.launch(src, idx, out, p),
        "gather_kernel.gather_cuda": lambda: ga.gather_cuda(src, idx),
        "torch.gather": lambda: torch.gather(src, 1, index),
        "fps 64->16 (furthest_point_sample_cuda)": lambda: fps.furthest_point_sample_cuda(src, 16),
        "torch.empty twice (i's two outputs)": lambda: (
            torch.empty((BATCH, 64, 3), device=src.device),
            torch.empty((BATCH, 64, 3), dtype=torch.int32, device=src.device)),
        "torch.empty once, two views (i's outputs in one buffer)": lambda: (
            lambda buf: (buf[0].view(torch.float32), buf[1]))(
            torch.empty((2, BATCH, 64, 3), dtype=torch.int32, device=src.device)),
        "p2_three_nn, nothing to launch": lambda: lib.p2_three_nn(
            *[0] * len(build._SIGNATURES["p2_three_nn"])),
        "p2_ball_query, nothing to launch": lambda: lib.p2_ball_query(
            *[0] * len(build._SIGNATURES["p2_ball_query"])),
        "three_nn 64x16 (three_nn_cuda, FP3)": lambda: nn3.three_nn_cuda(src, cen),
        "ball_query 64->16 (ball_query_cuda, SA4)": lambda: bq.ball_query_cuda(0.8, 32, src, cen),
        "p2_ball_query_multi, nothing to launch": lambda: lib.p2_ball_query_multi(
            *[0] * len(build._SIGNATURES["p2_ball_query_multi"])),
        "ball_query_multi 64->16 (ball_query_multi_cuda, MSG SA4)": lambda: bqm.ball_query_multi_cuda(
            (0.4, 0.8), (16, 32), src, cen),
        "three_nn_q 64x16 (three_nn_q_cuda, j's wrapper at FP3's shape)": lambda: nnq.three_nn_q_cuda(
            src, cen),
        "scatter_add 16x3 -> 64 (scatter_add_cuda, SA4's centroids' backward)": lambda: sc.scatter_add_cuda(
            idx, cen, 64),
    }
    for what, fn in pieces.items():
        print(f"host {what}: {host_us(torch, fn):.2f} us a call", flush=True)

    from pointnet2_scannet_tpu_torch import ops

    public = {
        "ops.furthest_point_sample 64->16 (public op, SA4)": lambda: ops.furthest_point_sample(src, 16),
        "ops.gather_points 64->16 (public op, SA4's centroids)": lambda: ops.gather_points(src, idx),
        "ops.ball_query 64->16 (public op, SA4)": lambda: ops.ball_query(0.8, 32, src, cen),
        "ops.ball_query_multi 64->16 (public op, MSG SA4)": lambda: ops.ball_query_multi(
            (0.4, 0.8), (16, 32), src, cen),
        "ops.three_nn 64x16 (public op, FP3)": lambda: ops.three_nn(src, cen),
    }
    try:
        from pointnet2_scannet_tpu_torch.ops import library
    except ImportError:  # a checkout from before the pn2:: ops
        library = None
    if library is not None:
        public.update({
            "pn2::furthest_point_sample alone 64->16": lambda: library.furthest_point_sample(src, 16, True),
            "pn2::gather alone 64->16": lambda: library.gather(src, idx),
            "pn2::ball_query alone 64->16": lambda: library.ball_query(0.8, 32, src, cen),
            "pn2::three_nn alone 64x16": lambda: library.three_nn(src, cen),
        })
    with torch.inference_mode():
        for what, fn in public.items():
            print(f"host {what}: {host_us(torch, fn):.2f} us a call", flush=True)


def serve_times(torch) -> None:
    """The eager Predictor's steady serving batch at 32 x 8192, SSG and MSG
    float32, beside an artifact's of the same weights where the checkout
    has export_forward, timed in turns."""
    import time

    import numpy as np

    from pointnet2_scannet_tpu_torch.engine import export
    from pointnet2_scannet_tpu_torch.models import get_model

    columns = np.random.default_rng(0).uniform(0, 1.5, (BATCH, 8192, 9)).astype(np.float32)
    for kind in ("ssg", "msg"):
        model = get_model(20, is_msg=kind == "msg", input_channels=6, generator=torch.Generator().manual_seed(0))
        shape = dict(batch_size=BATCH, npoints=8192, channels=9)
        predictors = {"Predictor": export.Predictor(model, device="cuda", **shape)}
        if hasattr(export, "export_forward"):
            exported = export.export_forward(model, platforms=["cuda"], **shape)
            predictors["artifact"] = export.ServingPredictor(exported)
        times = {name: [] for name in predictors}
        for p in predictors.values():
            p.predict(columns)
        for _ in range(9):
            for name, p in predictors.items():
                t0 = time.perf_counter()
                p.predict(columns)
                times[name].append(1e3 * (time.perf_counter() - t0))
        for name, t in times.items():
            t.sort()
            print(f"serve {kind.upper()} {BATCH} x 8192 {name}: {t[4]:.2f} ms median of 9 "
                  f"(min {t[0]:.2f}, max {t[-1]:.2f})", flush=True)
        # the host's share: ms until the forward returns (its launches queued)
        # and until the card is done, the batch already on the card
        forwards = {"Predictor": export.build_forward(predictors["Predictor"].model)}
        if "artifact" in predictors:
            forwards["artifact"] = exported.program.module()
        x = torch.from_numpy(columns).cuda()
        enqueue = {name: [] for name in forwards}
        done = {name: [] for name in forwards}
        with torch.inference_mode():
            for fwd in forwards.values():
                fwd(x)
            for _ in range(9):
                for name, fwd in forwards.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fwd(x)
                    enqueue[name].append(1e3 * (time.perf_counter() - t0))
                    torch.cuda.synchronize()
                    done[name].append(1e3 * (time.perf_counter() - t0))
        for name in forwards:
            print(f"serve {kind.upper()} {BATCH} x 8192 {name} forward: returns after "
                  f"{sorted(enqueue[name])[4]:.2f} ms, the card done after {sorted(done[name])[4]:.2f} ms "
                  "(medians of 9, in turns)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_scatter: no CUDA device", file=sys.stderr)
        return 1
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    kernels = [a for a in sys.argv[1:]
               if a in ("h", "f", "d", "a", "probe_a", "i", "b", "c", "j", "k", "host", "serve", "ptxas")] or ["h", "f"]
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
    if "host" in kernels:
        host_costs(torch)
    if "serve" in kernels:
        serve_times(torch)
    if "d" in kernels:
        profile_d(torch, routes)
    if "a" in kernels:
        profile_a(torch, routes)
    if "probe_a" in kernels:
        probe_a(torch)
    if "i" in kernels:
        profile_i(torch, routes)
    if "b" in kernels:
        profile_b(torch, routes)
    if "c" in kernels:
        profile_c(torch, routes)
    if "j" in kernels:
        profile_j(torch)
    if "k" in kernels:
        profile_k(torch, routes)
    if "f" in kernels:
        for label, (idx, n, c) in f_shapes(torch).items():
            idx = idx.contiguous()
            b, j = idx.shape
            g = torch.randn((b, j, c), generator=gen, device="cuda")
            src = torch.randn((b, n, c), generator=gen, device="cuda")
            report(torch, "f", label, idx, n, c, lambda: ss.scatter_smem_cuda(idx, g, n))
            report(torch, "e", label, idx, n, c, lambda: gs.gather_smem_cuda(src, idx))
            g16, src16 = g.to(torch.bfloat16), src.to(torch.bfloat16)
            report(torch, "f bf16", label, idx, n, c, lambda: ss.scatter_smem_cuda(idx, g16, n))
            report(torch, "e bf16", label, idx, n, c, lambda: gs.gather_smem_cuda(src16, idx))
    if "ptxas" in kernels:
        build.library()
        ptxas("e", "gather_smem_kernel")
        ptxas("f", "scatter_smem", "segment_sum")
        ptxas("f", "accumulate_kernel")
        ptxas("h", "scatter_add", "segment_sum")
        ptxas("h", "block_kernel")
        ptxas("a", "fps_kernel")
        ptxas("a", "fps_cluster_kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
