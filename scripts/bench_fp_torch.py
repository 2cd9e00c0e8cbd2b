"""FP-stack shootout: the four interpolation forms forward and backward per
level, with the PyTorch + CUDA port (the port of scripts/bench_fp.py).

    python scripts/bench_fp_torch.py [--dtype f32|bf16|both] [--three_nn]   # the card
    python scripts/bench_fp_torch.py --device cpu                           # plain versions, small

At each SSG FP level (bench_hotops_torch.FP_LEVELS, B = 32) and dtype, the
forward and backward of sum(interp(feats)^2) in feats, for
  dense  : three_interpolate_dense (W in feats' dtype, bmm; plain autograd)
  cached : three_interpolate_cached (W saved, one bmm backward)
  fast   : three_interpolate_fast (gather.cu forward, a dense bmm backward)
  gather : three_interpolate (gather.cu forward, scatter_add.cu backward;
           the card's default)
each held against the gather form first: the output and the gradient
within 1e-5 (float32) or 2^-7 (bfloat16) of their largest |value|.
--three_nn times 3-NN's known-major (t) route against the query-major (q)
route at each level (both three_nn.cu, under their own counters). Timing
is bench_hotops_torch.bench (CUDA events, outputs consumed). Prints one row
a time, then one JSON line with each level's fastest form.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench_torch  # noqa: E402
from scripts.bench_hotops_torch import FP_LEVELS, REPS, batch, bench, cloud, points, setup  # noqa: E402

FORMS = ("dense", "cached", "fast", "gather")
TOL = {"f32": 1e-5, "bf16": 2.0**-7}


def _inputs(torch, gen, b: int, n: int, m: int, c: int, dtype, device: str):
    from pointnet2_scannet_tpu_torch import ops

    _, idx = ops.three_nn(cloud(torch, gen, b, n, device), cloud(torch, gen, b, m, device))
    w = torch.rand((b, n, 3), generator=gen, device=device) * 0.9 + 0.1
    feats = torch.randn((b, m, c), generator=gen, device=device)
    return feats.to(dtype), idx, (w / w.sum(-1, keepdim=True)).to(dtype)


def _value_and_grad(torch, fn, feats, idx, w):
    x = feats.clone().requires_grad_(True)
    out = fn(x, idx, w)
    (g,) = torch.autograd.grad((out.float() ** 2).sum(), x)
    return out.detach(), g


def _agree(torch, got, want, tol: float, what: str) -> None:
    err = float((got.double() - want.double()).abs().max())
    if not err <= tol * float(want.double().abs().max()):
        raise RuntimeError(f"{what}: {err} from the gather form's")


def run(device: str = "cuda", dtypes=("f32", "bf16"), reps: int | None = None) -> dict:
    """{dtype: {level: {form: ms}}} of forward and backward."""
    torch = setup(device)
    from pointnet2_scannet_tpu_torch.ops.interpolate import interpolation

    reps = reps or (REPS if device == "cuda" else 2)
    gen = torch.Generator(device=device).manual_seed(0)
    b, out = batch(device), {}
    for dname in dtypes:
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        for name, n, m, c in FP_LEVELS:
            n, m = points(n, device), points(m, device)
            feats, idx, w = _inputs(torch, gen, b, n, m, c, dtype, device)
            want = _value_and_grad(torch, interpolation("gather"), feats, idx, w)
            times = out.setdefault(dname, {}).setdefault(name, {})
            for form in FORMS:
                fn = interpolation(form)
                got = _value_and_grad(torch, fn, feats, idx, w)
                for a, e, what in zip(got, want, ("output", "gradient")):
                    _agree(torch, a, e, TOL[dname], f"{dname} {name} {form} {what}")
                times[form] = bench(f"{dname} {name} interp {form} fwd+bwd (n={n} m={m} C={c})",
                                    lambda: _value_and_grad(torch, fn, feats, idx, w)[1], device, reps)
    return out


def run_three_nn(device: str = "cuda", reps: int | None = None) -> dict:
    """{level: {"t": ms, "q": ms}}: three_nn.cu under either route's op."""
    torch = setup(device)
    reps = reps or (REPS if device == "cuda" else 2)
    gen = torch.Generator(device=device).manual_seed(0)
    b, out = batch(device), {}
    for name, n, m, _ in FP_LEVELS:
        n, m = points(n, device), points(m, device)
        unk, kno = cloud(torch, gen, b, n, device), cloud(torch, gen, b, m, device)
        t, q = torch.ops.pn2.three_nn.default(unk, kno), torch.ops.pn2.three_nn_q.default(unk, kno)
        if not (torch.equal(t[0], q[0]) and torch.equal(t[1], q[1])):
            raise RuntimeError(f"{name}: the two routes' 3-NN differ")
        out[name] = {route: bench(f"{name} three_nn {route} (n={n} m={m})", lambda op=op: op(unk, kno), device,
                                  reps)
                     for route, op in (("t", torch.ops.pn2.three_nn.default),
                                       ("q", torch.ops.pn2.three_nn_q.default))}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--dtype", choices=("f32", "bf16", "both"), default="both")
    p.add_argument("--three_nn", action="store_true", help="3-NN's t route against its q route instead")
    p.add_argument("--reps", type=int, default=None, help=f"timed calls a row (default {REPS}; 2 on the CPU)")
    args = p.parse_args(argv)
    if args.three_nn:
        out = {"bench": "fp_three_nn", **bench_torch.card_fields(args.device), "batch": batch(args.device),
               "ms": run_three_nn(args.device, args.reps)}
    else:
        dtypes = ("f32", "bf16") if args.dtype == "both" else (args.dtype,)
        ms = run(args.device, dtypes, args.reps)
        fastest = {d: {lv: min(t, key=t.get) for lv, t in levels.items()} for d, levels in ms.items()}
        out = {"bench": "fp", **bench_torch.card_fields(args.device), "batch": batch(args.device), "ms": ms,
               "fastest": fastest}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
