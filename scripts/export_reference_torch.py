"""Export a checkpoint of the PyTorch + CUDA port (pointnet2_scannet_tpu_torch)
to the reference's state_dict format.

The reference stack (Pointnet2.ScanNet) loads the written file unchanged:
torch.load, then model.load_state_dict(strict=True) on its get_model of the
same kind, classes and input channels. The run dir holds the port's
config.json and <checkpoint>.pt, as scripts/train_torch.py writes them.

    python scripts/export_reference_torch.py --folder outputs/<stamp>_TAG \
        [--checkpoint model_best] [--out model.pth]

The file goes to <folder>/<checkpoint>.pth unless --out names another.
Imports torch and this package only; runs on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def export(args) -> pathlib.Path:
    """Write the run's checkpoint as a reference model.pth; returns its path."""
    from pointnet2_scannet_tpu_torch.engine.export import load_run_model
    from pointnet2_scannet_tpu_torch.models.convert import save_torch_pointnet2

    run_dir = pathlib.Path(args.folder)
    model, cfg = load_run_model(run_dir, args.checkpoint)
    out = pathlib.Path(args.out) if args.out else run_dir / f"{args.checkpoint}.pth"
    save_torch_pointnet2(out, model.state_dict(), model.spec)
    print(f"wrote {out} (reference-format state_dict, {'MSG' if cfg.model.is_msg else 'SSG'}, "
          f"input_channels={cfg.data.input_channels})")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--folder", type=str, required=True, help="the port's run dir")
    p.add_argument("--checkpoint", type=str, default="model_best")
    p.add_argument("--out", type=str, default=None, help="output .pth path")
    return p.parse_args(argv)


if __name__ == "__main__":
    export(parse_args())
