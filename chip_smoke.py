#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (pointnet2_scannet_tpu_torch) once on one GPU.

    python3 chip_smoke.py

1. The card: torch's device name and nvidia-smi's name and power limit.
2. Build the six CUDA kernels from csrc/ (nvcc, sm_90a) and time the build.
3. Each forward kernel against its plain PyTorch version on the card at the
   SSG serving path's shapes (32 columns of 8192 points, the four levels):
   indices and gathers must be equal bit for bit; both times from CUDA events
   after a warm-up.
4. The scatter-add (every gather's backward) at the seven shapes of the SSG
   train step, its indices the ball-query and 3-NN outputs of phase 3: equal
   bit for bit to the plain version run on CPU copies, and to itself across
   two launches.
5. The two-radius ball query of the MSG levels against its plain version at
   the four MSG levels (the same level clouds), bit for bit, timed beside
   two single-radius launches per level.
6. The gather at the MSG model's grouping and interpolation widths, and the
   scatter-add at its train step's backward shapes, both listed from the MSG
   model (its pregather gate picks which gathers a level makes): the checks
   of phases 3 and 4.
7. The MSG model with its pregather gate as it stands (on at SA3, SA4) and
   forced off: eval logits must agree; the serving forward and the train
   step at batch 32 x 8192 timed side by side.
8. Serve synthetic scenes through scripts/infer_torch.py, the SSG model then
   the MSG model, at full width (xyz + color + normal, 8192-point columns,
   batch 32, float32) with weights drawn from a seeded generator: the
   prediction files must hold labels in [0, 20), every forward kernel of the
   model's path must have moved its launch counter in that run (and no
   other), one batch's logits must agree with the plain path on the CPU, and
   the steady batch is timed.
9. Train through scripts/train_torch.py at the same width, SSG then MSG
   (--use_msg): 32 synthetic scenes, batch 32, 3 epochs of one step and one
   validation each. Losses must be finite, the run dir's artifacts must
   exist, and every kernel of the path must have moved its counter in that
   run.
10. For SSG then MSG: one train step on the card against one on the CPU (2
    full-width columns, Dropout off): loss, gradients and BatchNorm
    statistics within the stated bounds; two train steps on the card from
    one state and batch must give the same bits; the steady-state train
    step at batch 32 x 8192 (forward, loss, backward, Adam, confusion
    matrix), timed with CUDA events, and its peak device memory.
11. Print one JSON line of kernel results (time, plain time, the card's bound
    for the same work, the time of one PyTorch library call where one
    computes the same function), the card line, and last
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
KINDS = ("ssg", "msg")
# (points in, points out, radius, channels grouped beside xyz) per SSG level
LEVELS = ((8192, 1024, 0.1, 6), (1024, 256, 0.2, 64), (256, 64, 0.4, 128), (64, 16, 0.8, 256))
# logits of the card vs the CPU: f32 matmuls sum in another order in cuBLAS
# and in the CPU BLAS; every index the ops produce is identical
LOGIT_RTOL = LOGIT_ATOL = 1e-4
# channels of the features each SSG FP level interpolates (FP0 .. FP3)
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
# the card's bound for a kernel's work (one NVIDIA H100 SXM, published peaks
# at 700 W): bytes over the memory rate, float32 operations outside the
# tensor cores over their peak rate. Operations counted per kernel: FPS 10
# per point and step (d^2 8, running min 1, argmax compare 1); ball query 9
# per point a query's scan reads up to its k-th hit (d^2 8, 1 compare), the
# two-radius one 10 (2 compares) over the longer of its two scans; 3-NN 9
# per pair; the scatter-add 1 per added word; the gather none. Bytes: each
# input read once, each output written once; of a gather's source, the
# distinct rows its indices name in this run.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """The least ms the card could take for the work, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Tally:
    """One kernel's row of the JSON line: times, errors and bounds summed
    over the shapes it was checked at in this run, and per model path."""

    def __init__(self, module):
        self.module = module
        self.max_abs_err = 0.0
        self.paths: dict[str, dict] = {}

    def add(self, path, ms, plain_ms, err, nbytes, nops, library_ms=None, **extra):
        b, by = bound_ms(nbytes, nops)
        p = self.paths.setdefault(path, {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                         "bytes": 0.0, "operations": 0.0})
        p["ms"] += ms
        p["plain_ms"] += plain_ms
        p[by] += b
        if library_ms is not None:
            p["library_ms"] = (p["library_ms"] or 0.0) + library_ms
        for k, v in extra.items():
            p[k] = p.get(k, 0.0) + v
        self.max_abs_err = max(self.max_abs_err, err)

    def total(self, key):
        vals = [p[key] for p in self.paths.values() if p.get(key) is not None]
        return sum(vals) if vals else None

    def row(self, launches: int) -> dict:
        spent = {by: self.total(by) for by in ("bytes", "operations")}
        row = {
            "name": self.module.NAME,
            "route": "cuda",
            "source": self.module.SOURCE,
            "replaces": self.module.REPLACES,
            "launches": launches,
            "max_abs_err": self.max_abs_err,
            "ms": self.total("ms"),
            "plain_ms": self.total("plain_ms"),
            "bound_ms": spent["bytes"] + spent["operations"],
            "bound_by": max(spent, key=spent.get),
            "library_ms": self.total("library_ms"),
        }
        if self.total("two_single_ms") is not None:
            row["two_single_ms"] = self.total("two_single_ms")
        return row


def check(torch, tally, path, label, kernel_fn, plain_fn, nbytes, nops, library_fn=None, **extra):
    """A kernel against its plain version on the card, bit for bit, then
    both timed (and the library call, where there is one)."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    ms, plain_ms = cuda_ms(kernel_fn, torch), cuda_ms(plain_fn, torch)
    library_ms = cuda_ms(library_fn, torch) if library_fn is not None else None
    extra = {k: cuda_ms(fn, torch) for k, fn in extra.items()}
    tally.add(path, ms, plain_ms, err, nbytes, nops, library_ms, **extra)
    b, by = bound_ms(nbytes, nops)
    more = "".join(f", {k} {v:.4f} ms" for k, v in extra.items())
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    print(f"kernel {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}{more}, bound {b:.4f} ms "
          f"({by}), max_abs_err {err}, {'equal' if equal else 'DIFFERENT'}", flush=True)
    if not equal:
        raise RuntimeError(f"{label}: kernel and plain version differ (max_abs_err {err})")


def distinct_rows(idx) -> int:
    """Source rows a gather through idx (B, J) reads: the distinct indices
    of each batch row, summed."""
    s = idx.sort(dim=1).values
    return idx.shape[0] + int((s[:, 1:] != s[:, :-1]).sum())


def gather_check(torch, tally, path, label, src, idx):
    """The gather kernel at one shape, with torch.gather on an int64 index
    made beforehand as the library call."""
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    (b, _, c), j = src.shape, idx.shape[1]
    index = idx.long().unsqueeze(-1).expand(-1, -1, c)
    check(torch, tally, path, label, lambda: ga.gather_cuda(src, idx),
          lambda: ga.gather_plain(src, idx), 4 * (distinct_rows(idx) * c + b * j + b * j * c), 0,
          library_fn=lambda: torch.gather(src, 1, index))


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


def serving_columns(n_scenes: int):
    """Whole-scene columns of the synthetic scenes the serving run uses."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store

    cfg = DataConfig(npoints=NPOINTS, use_color=True, use_normal=True)
    ds = WholeSceneDataset(make_synthetic_store(n_scenes, seed=1000), cfg, seed=0)
    import numpy as np

    return np.concatenate([ds.get_scene(i)[0] for i in range(len(ds))])


def level_clouds(torch):
    """xyz of the five point sets (8192, 1024, 256, 64, 16 points) of a batch
    of 32 real synthetic columns, each level from the plain FPS of the one
    above, the FPS indices, and the input features."""
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps, gather_kernel as ga

    cols = serving_columns(2)
    if len(cols) < BATCH:
        raise RuntimeError(f"only {len(cols)} columns for a batch of {BATCH}")
    cols = torch.from_numpy(cols[:BATCH]).to("cuda")
    xyz = [cols[..., :3].contiguous()]
    fps_idx = []
    for _, n_out, _, _ in LEVELS:
        fps_idx.append(fps.furthest_point_sample_plain(xyz[-1], n_out))
        xyz.append(ga.gather_plain(xyz[-1], fps_idx[-1]).contiguous())
    return xyz, fps_idx, cols[..., 3:].contiguous()


def check_kernels(torch, tallies, xyz, fps_idx, input_feats) -> list:
    """Phase 3: every forward kernel vs its plain version at the SSG path's
    shapes. Returns the (label, idx (B, J), N, C) of every gather whose
    gradient the SSG train step takes, from these ball-query and 3-NN
    outputs."""
    from pointnet2_scannet_tpu_torch.ops.cuda import (
        ball_query_kernel as bq,
        fps_kernel as fps,
        gather_kernel as ga,
        three_nn_kernel as nn3,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = [input_feats]
    for _, _, _, c in LEVELS[1:]:
        feats.append(torch.randn((BATCH, xyz[len(feats)].shape[1], c), generator=gen, device="cuda"))
    backward = []
    for k, (n_in, n_out, radius, c) in enumerate(LEVELS):
        x, q = xyz[k], xyz[k + 1]
        check(torch, tallies[fps.NAME], "ssg", f"fps {n_in}->{n_out}",
              lambda: fps.furthest_point_sample_cuda(x, n_out),
              lambda: fps.furthest_point_sample_plain(x, n_out),
              4 * BATCH * (3 * n_in + n_out), 10 * BATCH * (n_out - 1) * n_in)
        gather_check(torch, tallies[ga.NAME], "ssg", f"gather centroids ({BATCH},{n_in},3)x{n_out}",
                     x, fps_idx[k])
        scans = int(scan_points(torch, x, q, radius, NSAMPLE).sum())
        check(torch, tallies[bq.NAME], "ssg", f"ball_query r={radius} N={n_in} M={n_out} ns={NSAMPLE}",
              lambda: bq.ball_query_cuda(radius, NSAMPLE, x, q),
              lambda: bq.ball_query_plain(radius, NSAMPLE, x, q),
              4 * BATCH * (3 * n_in + 3 * n_out + n_out * NSAMPLE), 9 * scans)
        nidx = bq.ball_query_cuda(radius, NSAMPLE, x, q).reshape(BATCH, -1)
        src = torch.cat([x, feats[k]], dim=-1).contiguous()
        gather_check(torch, tallies[ga.NAME], "ssg",
                     f"gather grouping ({BATCH},{n_in},{3 + c})x{nidx.shape[1]}", src, nidx)
        check(torch, tallies[nn3.NAME], "ssg", f"three_nn n={n_in} m={n_out}",
              lambda: nn3.three_nn_cuda(x, q), lambda: nn3.three_nn_plain(x, q),
              4 * BATCH * (3 * n_in + 3 * n_out + 6 * n_in), 9 * BATCH * n_in * n_out)
        if k > 0:  # SA1 groups input data: no gradient is taken there
            backward.append((f"SA{k + 1} grouping", nidx, n_in, 3 + c))
        nn_idx = nn3.three_nn_cuda(x, q)[1].reshape(BATCH, -1)
        backward.append((f"FP{k} interpolation", nn_idx, n_out, FP_CHANNELS[k]))
    return backward


def check_scatter(torch, tally, path, backward) -> None:
    """Phases 4 and 6: the scatter-add kernel against its plain version on
    CPU copies (which adds in ascending j, as the kernel does) and against a
    second launch, bit for bit; times against the plain version on the card
    (unordered atomics) and against scatter_add_ on an int64 index made
    beforehand."""
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc

    gen = torch.Generator(device="cuda").manual_seed(1)
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
        index = idx.long().unsqueeze(-1).expand(BATCH, j, c)
        ms = cuda_ms(lambda: sc.scatter_add_cuda(idx, g, n), torch)
        plain_ms = cuda_ms(lambda: sc.scatter_add_plain(idx, g, n), torch)
        library_ms = cuda_ms(lambda: torch.zeros((BATCH, n, c), device="cuda").scatter_add_(
            1, index, g), torch)
        nbytes, nops = 4 * BATCH * (j + j * c + n * c), BATCH * j * c
        tally.add(path, ms, plain_ms, err, nbytes, nops, library_ms)
        b, by = bound_ms(nbytes, nops)
        print(f"kernel scatter_add {path.upper()} {label} (B={BATCH}, J={j}, N={n}, C={c}): "
              f"{ms:.4f} ms, plain on the card {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {b:.4f} ms ({by}), max_abs_err vs CPU plain {err}, "
              f"{'equal' if equal else 'DIFFERENT'}, second launch "
              f"{'equal' if repeat else 'DIFFERENT'}", flush=True)
        if not (equal and repeat):
            raise RuntimeError(f"scatter_add {label}: kernel differs from the CPU plain version "
                               f"or from its own second launch (max_abs_err {err})")


def check_multi(torch, tallies, xyz) -> list:
    """Phase 5: the two-radius ball query at the four MSG levels, bit for
    bit against its plain version, timed beside two single-radius launches.
    Returns each level's (idx1, idx2)."""
    from pointnet2_scannet_tpu_torch.models import msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm

    spec = msg_spec(20, 6)
    out = []
    for k, (radii, ks) in enumerate(zip(spec.radii, spec.nsamples)):
        x, q = xyz[k], xyz[k + 1]
        n, m = x.shape[1], q.shape[1]
        scans = int(torch.maximum(scan_points(torch, x, q, radii[0], ks[0]),
                                  scan_points(torch, x, q, radii[1], ks[1])).sum())
        check(torch, tallies[bqm.NAME], "msg",
              f"ball_query_multi r={radii} N={n} M={m} ns={ks}",
              lambda: bqm.ball_query_multi_cuda(radii, ks, x, q),
              lambda: bqm.ball_query_multi_plain(radii, ks, x, q),
              4 * BATCH * (3 * n + 3 * m + m * sum(ks)), 10 * scans,
              two_single_ms=lambda: (bq.ball_query_cuda(radii[0], ks[0], x, q),
                                     bq.ball_query_cuda(radii[1], ks[1], x, q)))
        out.append(bqm.ball_query_multi_cuda(radii, ks, x, q))
    return out


def check_msg_gathers(torch, tallies, xyz, input_feats, multi_idx) -> list:
    """Phase 6: the gather at every shape of the MSG forward, listed from the
    MSG model: per level and scale, its pregather gate decides between one
    grouping gather of [xyz | features] (3 + C words a row) and the
    pregather's gathers of layer 0's output (widths[0] words) and the
    centred xyz (3 words); then each FP level's interpolation gather. Returns
    the (label, idx, N, C) of every gather whose gradient the MSG train step
    takes."""
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3

    spec = msg_spec(20, 6)
    model = PointNet2SemSeg(spec)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tally = tallies[ga.NAME]
    backward = []
    for k in range(len(spec.npoints)):
        sa = getattr(model, f"sa_{k}")
        c, x = spec.skip_channels[k], xyz[k]
        n = x.shape[1]
        feats = input_feats if k == 0 else torch.randn((BATCH, n, c), generator=gen, device="cuda")
        for s, mlp in enumerate(sa._mlps()):
            idx = multi_idx[k][s].reshape(BATCH, -1)
            where = f"SA{k + 1} scale {s}"
            if sa._pregather(torch.empty((1, 1, c)), mlp.widths):
                zf = torch.randn((BATCH, n, mlp.widths[0]), generator=gen, device="cuda")
                gathers = [(f"{where} pregather zf", zf, True), (f"{where} pregather xyz", x, False)]
            else:  # SA1 groups input data: no gradient is taken there
                src = torch.cat([x, feats], dim=-1).contiguous()
                gathers = [(f"{where} grouping", src, k > 0)]
            for label, src, grad in gathers:
                gather_check(torch, tally, "msg",
                             f"gather MSG {label} ({BATCH},{n},{src.shape[2]})x{idx.shape[1]}", src, idx)
                if grad:
                    backward.append((label, idx, n, src.shape[2]))
    for k in range(len(spec.fp_mlps)):
        c = spec.sa_out_channels[-1] if k == len(spec.fp_mlps) - 1 else spec.fp_mlps[k + 1][-1]
        x, q = xyz[k], xyz[k + 1]
        nn_idx = nn3.three_nn_cuda(x, q)[1].reshape(BATCH, -1)
        known = torch.randn((BATCH, q.shape[1], c), generator=gen, device="cuda")
        gather_check(torch, tally, "msg",
                     f"gather MSG FP{k} interpolation ({BATCH},{q.shape[1]},{c})x{nn_idx.shape[1]}",
                     known, nn_idx)
        backward.append((f"FP{k} interpolation", nn_idx, q.shape[1], c))
    return backward


def time_pregather(torch) -> None:
    """Phase 7: the MSG model at 32 x 8192 with its pregather gate as it
    stands (on at SA3 and SA4 in float32) and forced off (the unfused
    composition at every level). The eval logits of the two must agree;
    the serving forward and the train step are timed with CUDA events, in
    the order on, off, off, on."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import SetAbstraction

    batch = train_batch(torch, BATCH, "cuda")
    state = fresh_state(torch, 0.5, "cuda", "msg")
    model = state.model
    levels = [m for m in model.modules() if isinstance(m, SetAbstraction)]

    def gate(on: bool) -> None:
        for sa in levels:
            if on:
                vars(sa).pop("_pregather", None)
            else:
                sa._pregather = lambda features, widths: False

    def forward():
        model.eval()
        with torch.inference_mode():
            return model(batch["points"])

    logits = {}
    for on in (True, False):
        gate(on)
        logits[on] = forward()
    torch.testing.assert_close(logits[True], logits[False], rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    err = float((logits[True] - logits[False]).abs().max())
    times = {(on, what): [] for on in (True, False) for what in ("serve forward", "train step")}
    for on in (True, False, False, True):
        gate(on)
        times[(on, "serve forward")].append(cuda_ms(forward, torch))
        times[(on, "train step")].append(
            cuda_ms(lambda: ts.train_step(state, batch, num_classes=20), torch))
    gate(True)
    print(f"pregather MSG (B={BATCH} x {NPOINTS}): logits gate on vs off max_abs_err {err}; "
          + "; ".join(f"{what} gate {'on' if on else 'off'} "
                      + " / ".join(f"{t:.3f}" for t in ms) + " ms"
                      for (on, what), ms in times.items()), flush=True)


def on_path(kind: str, training: bool) -> tuple[set, set]:
    """(kernels a run of the model must launch, kernels it must not)."""
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    other_query = "ball_query_multi" if kind == "ssg" else "ball_query"
    names = {k.NAME for k in kernels.KERNELS}
    # serving runs under inference_mode: no backward, so no scatter-add
    off = {other_query} | (set() if training else {"scatter_add"})
    return names - off, off


def check_launches(launches: dict, kind: str, training: bool, what: str) -> None:
    want, off = on_path(kind, training)
    missing = sorted(k for k in want if launches[k] == 0)
    stray = sorted(k for k in off if launches[k] != 0)
    if missing or stray:
        raise RuntimeError(f"the {what} run launched no {missing} kernel, or launched {stray}")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve(torch, tmp: pathlib.Path, kind: str) -> dict:
    """Phase 8: the serving path end to end, through the kernels."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig, ModelConfig, RunConfig
    from pointnet2_scannet_tpu_torch.engine.checkpoint import save_state_dict
    from pointnet2_scannet_tpu_torch.engine.export import Predictor
    from pointnet2_scannet_tpu_torch.models import get_model
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = kind.upper()
    run = tmp / f"run_{kind}"
    run.mkdir()
    RunConfig(
        tag="chip_smoke",
        data=DataConfig(npoints=NPOINTS, use_color=True, use_normal=True),
        model=ModelConfig(is_msg=kind == "msg"),
    ).save(run / "config.json")
    model = get_model(20, is_msg=kind == "msg", input_channels=6,
                      generator=torch.Generator().manual_seed(0))
    save_state_dict(run, "model_best", model.state_dict())

    infer_torch = load_script("infer_torch")
    out_dir = tmp / f"out_{kind}"
    args = infer_torch.parse_args([
        "--folder", str(run), "--device", "cuda", "--synthetic",
        "--synthetic_scenes", "4", "--batch_size", str(BATCH), "--out", str(out_dir),
    ])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    stats = infer_torch.infer(args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"serve {name}: launches {launches}", flush=True)
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check_launches(launches, kind, False, f"{name} serving")

    files = sorted(out_dir.glob("*_pred.npy"))
    if len(files) != 4:
        raise RuntimeError(f"expected 4 prediction files, found {len(files)}")
    for f in files:
        pred = np.load(f)
        labels = pred[:, 3]
        if pred.ndim != 2 or pred.shape[1] != 4 or not np.isfinite(pred).all():
            raise RuntimeError(f"{f.name}: bad prediction array {pred.shape}")
        if labels.min() < 0 or labels.max() >= 20 or not np.all(labels == np.round(labels)):
            raise RuntimeError(f"{f.name}: labels outside [0, 20)")
    print(f"serve {name}: {stats['scenes']} scenes, {stats['columns']} columns, "
          f"{stats['points']} points; predict {stats['predict_s']:.3f} s, "
          f"end to end {stats['total_s']:.3f} s; peak device memory "
          f"{stats['peak_gib']:.2f} GiB", flush=True)

    batch = serving_columns(2)[:BATCH]
    gpu = Predictor.from_run(run, batch_size=BATCH, emit="logits", device="cuda")
    cpu = Predictor.from_run(run, batch_size=BATCH, emit="logits", device="cpu")
    got, want = gpu.predict(batch), cpu.predict(batch)
    err = float(np.abs(got - want).max())
    print(f"logits {name}: card vs CPU plain path over {batch.shape}: max_abs_err {err} "
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
    print(f"serve {name} steady state: batch of {len(batch)} columns in {dt * 1e3:.2f} ms median "
          f"of {len(times)} (min {times[0] * 1e3:.2f}, max {times[-1] * 1e3:.2f}): "
          f"{stats['steady_columns_per_s']:.1f} columns/s, "
          f"{stats['steady_points_per_s']:.0f} points/s; serving run "
          f"{stats['columns'] / stats['predict_s']:.1f} columns/s "
          f"{stats['points'] / stats['predict_s']:.0f} points/s in predict, "
          f"{stats['columns'] / stats['total_s']:.1f} columns/s end to end", flush=True)
    stats["launches"] = launches
    return stats


def train_cli(torch, tmp: pathlib.Path, kind: str) -> dict:
    """Phase 9: training through scripts/train_torch.py, through the kernels."""
    import math

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = kind.upper()
    train_torch = load_script("train_torch")
    args = train_torch.parse_args([
        "--synthetic", "--synthetic_scenes", str(BATCH), "--batch_size", str(BATCH),
        "--epoch", "3", "--npoints", str(NPOINTS), "--use_color", "--use_normal",
        "--verbose", "1", "--device", "cuda", "--tag", "chip_smoke",
        "--output_root", str(tmp / f"train_{kind}"), *(["--use_msg"] if kind == "msg" else []),
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
    print(f"train {name}: launches {launches}", flush=True)
    check_launches(launches, kind, True, f"{name} training")
    for f in ("model_best.pt", "model_last.pt", "config.json", "best.txt",
              "model_last.train.pt", "tensorboard/all_scalars.json"):
        if not (run_dir / f).is_file():
            raise RuntimeError(f"the training run wrote no {f}")
    if json.loads((run_dir / "config.json").read_text())["model"]["is_msg"] != (kind == "msg"):
        raise RuntimeError("the run dir's config.json records another model")
    scalars = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    losses = [v for _, v in scalars["train/loss"]] + [v for _, v in scalars["val/loss"]]
    if len(scalars["train/loss"]) != 3 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train/val losses {losses}: not 3 epochs of finite values")
    print(f"train {name}: 3 steps of {BATCH} x {NPOINTS} and 3 validations in {took:.2f} s; "
          f"losses {losses}; best val voxel mIoU {best['voxel_miou']:.4f}; peak device memory "
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


def fresh_state(torch, dropout: float, device, kind: str, seed: int = 0):
    """A train state over a seeded SSG or MSG model at full width."""
    import dataclasses

    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec, ssg_spec

    spec = dataclasses.replace((msg_spec if kind == "msg" else ssg_spec)(20, 6), dropout=dropout)
    model = PointNet2SemSeg(spec, generator=torch.Generator().manual_seed(seed), device=device)
    return ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=seed)


def grad_errors(got: dict, want: dict) -> list:
    """Per-tensor relative L2 error of gradients, sorted, worst first."""
    return sorted(((float((got[k].double() - w).norm() / w.norm()), k) for k, w in want.items()),
                  reverse=True)


def train_step_card_vs_cpu(torch, kind: str) -> None:
    """Phase 10a: one train step from the same weights on the card and on the
    CPU (float32 both, and float64 on the CPU as the reference), Dropout
    off."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        state = fresh_state(torch, 0.0, device, kind)
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
    print(f"train step {kind.upper()} card vs CPU (2 x {NPOINTS}): loss {gpu_loss} vs {cpu_loss} "
          f"(rel {loss_err:.2e}); BatchNorm stats max abs err {bn_err:.2e}; gradients, per-tensor "
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


def train_step_repeat_and_time(torch, kind: str) -> dict:
    """Phase 10b and 10c: two identical steps on the card give the same bits;
    then the warm step at batch 32, timed with CUDA events."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    name = kind.upper()
    batch = train_batch(torch, BATCH, "cuda")
    states = []
    for _ in range(2):
        state = fresh_state(torch, 0.5, "cuda", kind)
        ts.train_step(state, batch, num_classes=20)
        states.append(state.model.state_dict())
    differ = [k for k, v in states[0].items() if not torch.equal(states[1][k], v)]
    print(f"train step {name} determinism (B={BATCH}, Dropout 0.5): {len(states[0])} tensors, "
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
    print(f"train {name} steady state: step of {BATCH} x {NPOINTS} in {ms:.2f} ms median of "
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
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
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

    tallies = {k.NAME: Tally(k) for k in kernels.KERNELS}
    xyz, fps_idx, input_feats = level_clouds(torch)
    backward = check_kernels(torch, tallies, xyz, fps_idx, input_feats)
    check_scatter(torch, tallies["scatter_add"], "ssg", backward)
    multi_idx = check_multi(torch, tallies, xyz)
    backward = check_msg_gathers(torch, tallies, xyz, input_feats, multi_idx)
    check_scatter(torch, tallies["scatter_add"], "msg", backward)
    time_pregather(torch)
    del backward, multi_idx, xyz, fps_idx, input_feats
    for name, t in tallies.items():
        for path, p in t.paths.items():
            print(f"kernel {name} over the {path.upper()} shapes: " + ", ".join(
                f"{k} {v:.4f}" for k, v in p.items() if v is not None), flush=True)

    launches = {name: 0 for name in tallies}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for model_kind in KINDS:
            for run in (serve(torch, pathlib.Path(tmp), model_kind),
                        train_cli(torch, pathlib.Path(tmp), model_kind)):
                for name, n in run["launches"].items():
                    launches[name] += n
    for model_kind in KINDS:
        train_step_card_vs_cpu(torch, model_kind)
        train_step_repeat_and_time(torch, model_kind)

    print(json.dumps({"kernels": [t.row(launches[name]) for name, t in tallies.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
