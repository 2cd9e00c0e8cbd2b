"""ENet multiview feature-extraction throughput of the PyTorch + CUDA port
(frames/s): the port's counterpart of scripts/bench_enet.py.

The offline multiview stage 1 (scripts/multiview_torch.py): the eval-mode
ENetEncoder forward on a batch of frames at the production shape (256 x 328
RGB -> 32 x 41 x 128 features), random weights (torch.manual_seed(0): the
same operations and layout as the reference's checkpoint) and random frames
(numpy seeded 0, uniform in [-2, 2)). Float32 with TF32 off, then the module
and frames cast to bfloat16 (the JAX bench casts its parameters). Time:
CUDA events around 10 back-to-back forwards after 3 warm-up forwards.

    python scripts/bench_enet_torch.py [BATCH]          # the card, B = 64 by default
    python scripts/bench_enet_torch.py --device cpu     # a check of the flow: B 2, 64 x 96 frames

Prints one JSON line: enet_feature_extraction_frames_per_sec (`value`,
float32), bf16_frames_per_sec, the ms of a forward in each, the card's name
and power limit (device "cpu" with --device cpu).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# per device: default batch, frame (H, W), warm-up and timed forwards
SIZES = {"cuda": {"batch": 64, "frame": (256, 328), "warm": 3, "reps": 10},
         "cpu": {"batch": 2, "frame": (64, 96), "warm": 1, "reps": 1}}


def forward_ms(device, batch: int, frame: tuple[int, int], dtype, warm: int, reps: int) -> float:
    """ms a forward of the encoder over `reps` forwards, in dtype."""
    import numpy as np
    import torch

    from pointnet2_scannet_tpu_torch.models.enet import ENetEncoder

    torch.manual_seed(0)
    model = ENetEncoder().to(device=device, dtype=dtype).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, (batch, *frame, 3)).astype(np.float32))
    x = x.to(device=device, dtype=dtype)
    cuda = torch.device(device).type == "cuda"
    with torch.inference_mode():
        for _ in range(warm):
            out = model(x)
        if out.shape != (batch, frame[0] // 8, frame[1] // 8, 128) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"ENet features of shape {tuple(out.shape)} or not finite")
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                model(x)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            model(x)
        return (time.perf_counter() - t0) * 1e3 / reps


def run(device: str = "cuda", batch: int | None = None) -> dict:
    """Both dtypes on `device`; the JSON row."""
    import torch

    import pointnet2_scannet_tpu_torch  # noqa: F401  (switches TF32 off)
    from bench_torch import card_fields

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    size = SIZES[device]
    b = batch or size["batch"]
    ms = {name: forward_ms(device, b, size["frame"], dt, size["warm"], size["reps"])
          for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    h, w = size["frame"]
    row = {"metric": "enet_feature_extraction_frames_per_sec", "value": b / ms["f32"] * 1e3,
           "unit": "frames/sec", "bf16_frames_per_sec": b / ms["bf16"] * 1e3,
           "forward_ms": ms["f32"], "forward_ms_bf16": ms["bf16"],
           "detail": f"B={b} {h}x{w} RGB -> 128x{h // 8}x{w // 8}, {device}"}
    return {**row, **card_fields(device)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("batch", type=int, nargs="?", default=None, help="frames a forward")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(run(args.device, args.batch)), flush=True)


if __name__ == "__main__":
    main()
