"""The pregather layer-0 composition at the mv131 recipe, with the PyTorch +
CUDA port (the port of scripts/bench_pregather.py).

    python scripts/bench_pregather_torch.py [--quick]   # the card
    python scripts/bench_pregather_torch.py --device cpu  # plain versions, small

Two questions, each per dtype (f32, bf16):
1. SA1's block (SetAbstraction: 1024 centroids, r 0.1, K 32, widths
   (32, 32, 64), 131 feature channels: C_in 134 against widths[0] 32) at
   B = 32 x 8192 (--quick: B = 8), forward, and forward with backward (in
   the features and the parameters), with ops_config.pregather_dense True
   (layer 0 before the gather) and False (the grouped composition).
2. The mv131 train step (SSG; MSG too without --quick) at 32 x 8192:
   pregather_dense False against None (the gate: SA1 in f32, none in bf16
   training), eager steps (bench_torch.train_ms).
The block's outputs under both settings are held within 1e-4 (f32) or
2^-6 (bf16) of their largest |value| first. CUDA events on the card, the
host clock on the CPU (--device cpu: B = 1 x 1024 points, 128 centroids;
the train step 2 x 1024, one step). Prints one row a time, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench_torch  # noqa: E402
from scripts.bench_hotops_torch import REPS, bench, setup  # noqa: E402

MV131 = 131  # xyz + normal + 128-d ENet features: the feature channels beside xyz
SA1 = dict(npoint=1024, radii=[0.1], nsamples=[32], mlps=[[32, 32, 64]])
TOL = {"f32": 1e-4, "bf16": 2.0**-6}


def _dtype(torch, name: str):
    return torch.bfloat16 if name == "bf16" else None


def sa1_block(device: str, dname: str, quick: bool, reps: int) -> dict:
    """{"<setting> fwd" | "<setting> fwd+bwd": ms} of SA1's block."""
    torch = setup(device)
    from pointnet2_scannet_tpu_torch.models import modules
    from pointnet2_scannet_tpu_torch.ops import tuning

    cuda = device == "cuda"
    b, n, npoint = ((8 if quick else 32), 8192, SA1["npoint"]) if cuda else (1, 1024, 128)
    gen = torch.Generator(device=device).manual_seed(0)
    xyz = torch.rand((b, n, 3), generator=gen, device=device) * 1.5
    feats = torch.randn((b, n, MV131), generator=gen, device=device)
    sa = modules.SetAbstraction(npoint, SA1["radii"], SA1["nsamples"], SA1["mlps"], MV131,
                                dtype=_dtype(torch, dname), device=device).eval()
    out, first = {}, None
    for flag, label in ((False, "unfused"), (True, "pregather")):
        saved = tuning.ops_config.pregather_dense
        tuning.ops_config.pregather_dense = flag
        try:
            with torch.no_grad():
                h = sa(xyz, feats)[1]
            if first is None:
                first = h
            elif not float((h.double() - first.double()).abs().max()) <= TOL[dname] * float(
                    first.double().abs().max()):
                raise RuntimeError(f"SA1 {dname}: the pregather's output differs from the unfused one's")

            def fwd():
                with torch.no_grad():
                    return sa(xyz, feats)[1]

            def fwdbwd():
                f = feats.clone().requires_grad_(True)
                h = sa(xyz, f)[1]
                return torch.autograd.grad(h.float().sum(), [f, *sa.parameters()])

            what = f"sa1_mv131 {dname} {label}"
            out[f"{label} fwd"] = bench(f"{what} fwd (B={b}, N={n})", fwd, device, reps)
            out[f"{label} fwd+bwd"] = bench(f"{what} fwd+bwd", fwdbwd, device, reps)
        finally:
            tuning.ops_config.pregather_dense = saved
    return out


def train_step(device: str, dname: str, quick: bool) -> dict:
    """{"<kind> <setting>": median ms} of the mv131 train step."""
    torch = setup(device)
    from pointnet2_scannet_tpu_torch.ops import tuning

    cuda = device == "cuda"
    batch, npoints, steps, warm = (32, 8192, 5, 2) if cuda else (2, 1024, 1, 0)
    out = {}
    for flag, label in ((False, "unfused"), (None, "pregather-auto")):
        for kind in ("ssg",) if quick or not cuda else ("ssg", "msg"):
            saved = tuning.ops_config.pregather_dense
            tuning.ops_config.pregather_dense = flag
            try:
                times = bench_torch.train_ms(kind, device, batch, npoints, steps, warm,
                                             dtype=_dtype(torch, dname), input_channels=MV131)
            finally:
                tuning.ops_config.pregather_dense = saved
            med = times[len(times) // 2]
            out[f"{kind} {label}"] = med
            print(f"train {kind}_mv131 {dname} {label:14s} step {med:8.2f} ms (min {times[0]:.2f} max "
                  f"{times[-1]:.2f}) {batch * npoints / med / 1e3:.3f} Mpts/s", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--quick", action="store_true", help="SA1 at B = 8; the train step of SSG alone")
    p.add_argument("--reps", type=int, default=None, help=f"timed calls a row (default {REPS}; 2 on the CPU)")
    args = p.parse_args(argv)
    reps = args.reps or (REPS if args.device == "cuda" else 2)
    blocks = {d: sa1_block(args.device, d, args.quick, reps) for d in ("f32", "bf16")}
    steps = {d: train_step(args.device, d, args.quick) for d in ("f32", "bf16")}
    out = {"bench": "pregather", **bench_torch.card_fields(args.device), "quick": args.quick, "sa1_ms": blocks,
           "train_step_ms": steps}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
