"""Time the row-gather lowerings and their backwards at the SSG model's SA1
shape, with the PyTorch + CUDA port (the port of scripts/bench_gather.py).

    python scripts/bench_gather_torch.py                 # the card
    python scripts/bench_gather_torch.py --device cpu    # plain versions, small

Shape: B = 32 batch rows, J = 1024 x 32 = 32768 rows gathered from N = 8192
points of C in {9, 32, 64} channels (--device cpu: B = 2, N = 1024, J =
4096). Forward, each through the call a user makes:
- torch.gather (the library call; the port never makes it),
- d: ops.sampling.gather_rows (gather.cu),
- e: ops.mxu_gather.mxu_gather (gather_smem.cu),
- g: ops.mxu_gather.mxu_gather_split (gather_smem.cu, its own wrapper).
Backward of each, from one recorded forward: scatter_add_ (atomics), h
(scatter_add.cu), f (scatter_smem.cu) and g's backward (h). Every forward
must equal torch.gather's output bit for bit, and every ordered backward
(h, f, g's) the others bit for bit. On the card a time is the mean over
--reps calls between CUDA events, after a warm-up; on the CPU the host
clock's.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHAPES = {"cuda": (32, 8192, 32768), "cpu": (2, 1024, 4096)}  # B, N, J
CHANNELS = (9, 32, 64)


def _ms(torch, fn, reps: int, cuda: bool) -> float:
    fn()  # warm-up
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(device: str = "cuda", reps: int = 20, channels=CHANNELS) -> list[dict]:
    """Per C, the forward and backward times of the four lowerings (ms)."""
    import torch

    from pointnet2_scannet_tpu_torch.ops.mxu_gather import mxu_gather, mxu_gather_split
    from pointnet2_scannet_tpu_torch.ops.sampling import gather_rows

    cuda = device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    B, N, J = SHAPES[device]
    gen = torch.Generator(device=device).manual_seed(0)
    ops = {
        "torch.gather": lambda s, i, index: torch.gather(s, 1, index),
        "d gather_rows": lambda s, i, index: gather_rows(s, i),
        "e mxu_gather": lambda s, i, index: mxu_gather(s, i),
        "g mxu_gather_split": lambda s, i, index: mxu_gather_split(s, i),
    }
    rows = []
    for C in channels:
        src = torch.randn((B, N, C), generator=gen, device=device)
        idx = torch.randint(0, N, (B, J), generator=gen, device=device, dtype=torch.int32)
        index = idx.long().unsqueeze(-1).expand(B, J, C)
        g = torch.randn((B, J, C), generator=gen, device=device)
        want = torch.gather(src, 1, index)
        row = {"C": C, "B": B, "N": N, "J": J, "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
        grads = {}
        for name, op in ops.items():
            out = op(src, idx, index)
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} C={C}: forward differs from torch.gather")
            row[f"fwd {name}"] = _ms(torch, lambda: op(src, idx, index), reps, cuda)
            x = src.clone().requires_grad_(True)
            y = op(x, idx, index)
            grads[name] = torch.autograd.grad(y, x, g, retain_graph=True)[0]
            row[f"bwd {name}"] = _ms(
                torch, lambda: torch.autograd.grad(y, x, g, retain_graph=True), reps, cuda)
        ordered = [grads[k] for k in ops if k != "torch.gather"]
        if not all(torch.equal(a, ordered[0]) for a in ordered[1:]):
            raise RuntimeError(f"C={C}: the ordered backwards differ")
        err = float((ordered[0] - grads["torch.gather"]).abs().max())
        row["bwd max_abs_err vs scatter_add_"] = err
        rows.append(row)
        print(f"== C={C} (B={B}, N={N}, J={J}, {row['device']}) ==", flush=True)
        for k, v in row.items():
            if k.startswith(("fwd", "bwd ")) and isinstance(v, float) and "err" not in k:
                print(f"{k:<36} {v:9.4f} ms", flush=True)
        print(f"ordered backwards equal; scatter_add_ (atomics) within {err:.3g}", flush=True)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    run(args.device, args.reps)


if __name__ == "__main__":
    main()
