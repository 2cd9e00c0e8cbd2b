"""Time the SA1 row gather fused with the layer-0 matmul against the unfused
composition, with the PyTorch + CUDA port (the port of
scripts/bench_fused_sa.py).

    python scripts/bench_fused_sa_torch.py                 # the card
    python scripts/bench_fused_sa_torch.py --device cpu    # plain versions, small

Shape: B = 32 batch rows, J = 1024 x 32 = 32768 rows gathered from N = 8192
points of C = 9 channels, times a (9, 32) layer-0 weight (--device cpu: B =
2, N = 1024, J = 4096). The inputs come from numpy's generator seeded 0, as
in the JAX script. Checked first: the fused kernel (ops.fused_gather_mm,
fused_gather_mm.cu) and the unfused composition (ops.sampling.gather_rows,
gather.cu, then torch.matmul) against a float64 numpy reference, each within
1e-5 of max |ref|. Then timed: the gather alone, the gather and torch.matmul,
and the fused kernel. On the card a time is the mean over --reps calls
between CUDA events, after a warm-up; on the CPU the host clock's.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHAPES = {"cuda": (32, 8192, 32768), "cpu": (2, 1024, 4096)}  # B, N, J
C, F = 9, 32
REL_ERR = 1e-5  # of max |ref|, the JAX script's bound


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


def run(device: str = "cuda", reps: int = 20) -> dict:
    """The fused and unfused errors against float64 and the three times (ms)."""
    import numpy as np
    import torch

    from pointnet2_scannet_tpu_torch import ops
    from pointnet2_scannet_tpu_torch.ops.sampling import gather_rows

    cuda = device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    B, N, J = SHAPES[device]
    rng = np.random.default_rng(0)
    src_h = rng.normal(size=(B, N, C)).astype(np.float32)
    idx_h = rng.integers(0, N, size=(B, J)).astype(np.int32)
    w_h = rng.normal(size=(C, F)).astype(np.float32) * np.float32(0.1)
    ref = np.einsum("bjc,cf->bjf", np.take_along_axis(src_h.astype(np.float64), idx_h[..., None], axis=1),
                    w_h.astype(np.float64))
    scale = float(np.max(np.abs(ref)))
    src, idx, w = (torch.from_numpy(a).to(device) for a in (src_h, idx_h, w_h))

    fused = lambda: ops.fused_gather_mm(src, idx, w)  # noqa: E731
    unfused = lambda: gather_rows(src, idx) @ w  # noqa: E731
    gather_only = lambda: gather_rows(src, idx)  # noqa: E731
    with torch.inference_mode():
        row = {"B": B, "N": N, "J": J, "C": C, "F": F,
               "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
        for name, fn in (("fused", fused), ("unfused", unfused)):
            got = fn().double().cpu().numpy()
            row[f"{name} rel err"] = float(np.max(np.abs(ref - got))) / scale
        print(f"rel max err vs f64: fused kernel {row['fused rel err']:.2e} | "
              f"unfused gather+matmul {row['unfused rel err']:.2e}", flush=True)
        if not (row["fused rel err"] < REL_ERR and row["unfused rel err"] < REL_ERR):
            raise RuntimeError(f"an error exceeds {REL_ERR} of max |ref|: {row}")
        for name, fn in (("gather-only", gather_only), ("gather+matmul", unfused), ("fused", fused)):
            row[f"{name} ms"] = _ms(torch, fn, reps, cuda)
    print(f"SA1 (B={B} J={J} N={N} C={C} F={F}) f32 on {row['device']}: "
          f"gather-only {row['gather-only ms']:.4f} ms | gather+matmul {row['gather+matmul ms']:.4f} ms | "
          f"fused kernel {row['fused ms']:.4f} ms", flush=True)
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    run(args.device, args.reps)


if __name__ == "__main__":
    main()
