"""bfloat16 against float32 convergence of the PyTorch + CUDA port
(pointnet2_scannet_tpu_torch): the port's counterpart of
scripts/convergence_bf16.py.

Two 12-epoch runs of the chunked Solver over the same 4 synthetic scenes of
15 000 points (1024-point chunks, batch 4, xyz + colour + normal, data
seed 0), float32 then the bfloat16 compute dtype (float32 parameters, Adam
state and loss; bfloat16 MLPs and the packed [xyz_hi | xyz_lo | features]
grouping), from the same weights, the SSG model or with --msg the MSG
model. The weights are the port's seeded draw (torch.Generator seed 0),
or with --init a state_dict saved by torch.save (for instance the JAX
package's initial weights moved by models/convert.py, as
tests/test_torch_bf16_convergence.py makes them). Prints one JSON line:
the head and settled tail means (first and last three epochs) of val
point mIoU and train loss of both dtypes, the curves, and the device they
ran on.

  python scripts/convergence_bf16_torch.py            # the card
  python scripts/convergence_bf16_torch.py --msg
  python scripts/convergence_bf16_torch.py --device cpu --init weights.pt
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def run(dtype_name: str, store, epochs: int, out: pathlib.Path, device: str, is_msg: bool = False,
        init: dict | None = None):
    """(train losses, val point mIoUs) an epoch of one Solver run from the
    state_dict init, else from the weights torch.Generator seed 0 draws."""
    import torch

    from pointnet2_scannet_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.engine.solver import Solver
    from pointnet2_scannet_tpu_torch.models import model_from_config

    cfg = RunConfig(
        tag=f"bf16conv-{dtype_name}",
        data=DataConfig(npoints=1024, use_color=True, use_normal=True),
        model=ModelConfig(is_msg=is_msg, compute_dtype=dtype_name),
        train=TrainConfig(batch_size=4, epochs=epochs, lr=1e-3, verbose=100, seed=0),
    )
    train_ds = ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
    val_ds = ChunkedSceneDataset(store, cfg.data, phase="val", seed=1)
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(init, strict=True)
    out.mkdir(parents=True)
    solver = Solver(model, train_ds, val_ds, cfg, out, device=device)
    solver()
    losses = [v for _, v in solver.logger.scalars["train/loss"]]
    mious = [v for _, v in solver.logger.scalars["val/point_miou"]]
    return losses, mious


def compare(epochs: int, device: str, is_msg: bool = False, init: dict | None = None) -> dict:
    """Both dtypes' runs over one store from the same weights (init, else
    the seeded draw); the JSON row."""
    import torch

    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_store

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available (use --device cpu)")
    store = make_synthetic_store(n_scenes=4, n_points=15_000)
    curves = {}
    with tempfile.TemporaryDirectory() as td:
        for name, prefix in (("float32", "f32"), ("bfloat16", "bf16")):
            curves[f"{prefix}_losses"], curves[f"{prefix}_mious"] = run(
                name, store, epochs, pathlib.Path(td) / name, device, is_msg, init)

    def tail(key):
        return float(np.mean(curves[key][-3:]))

    def head(key):
        return float(np.mean(curves[key][:3]))

    return {
        "metric": ("msg_" if is_msg else "") + "bf16_vs_f32_val_point_miou_tail",
        "value": tail("bf16_mious"),
        "unit": "mIoU",
        "f32_tail": tail("f32_mious"),
        "delta": tail("bf16_mious") - tail("f32_mious"),
        "f32_loss_tail": tail("f32_losses"),
        "bf16_loss_tail": tail("bf16_losses"),
        "f32_head": head("f32_mious"), "bf16_head": head("bf16_mious"),
        "f32_loss_head": head("f32_losses"), "bf16_loss_head": head("bf16_losses"),
        **curves,
        "init": "given" if init is not None else "seeded",
        "epochs": epochs,
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--msg", action="store_true", help="drive the MSG model instead of SSG")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--init", type=pathlib.Path, help="a torch.save'd state_dict to start both runs from")
    args = ap.parse_args(argv)
    init = None
    if args.init is not None:
        import torch

        init = torch.load(args.init, map_location="cpu", weights_only=True)
    print(json.dumps(compare(args.epochs, args.device, args.msg, init)), flush=True)


if __name__ == "__main__":
    main()
