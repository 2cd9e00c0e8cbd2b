"""Convert a JAX run dir's checkpoint into a port checkpoint.

Reads <folder>/config.json and <folder>/<checkpoint>.msgpack with the JAX
package (engine/checkpoint.restore_params_only) and writes
<folder>/<checkpoint>.pt through models/convert.state_dict_from_jax, so the
port can serve a JAX-trained run on a GPU: a semantic-segmentation run
(scripts/train.py; scripts/infer_torch.py serves it) or a shape-family run
(scripts/train_cls.py, train_partseg.py; scripts/eval_shapes_torch.py and
infer_torch.py --export take it), the kind read from config.json
(engine/export.run_kind). Runs where jax, flax and torch are all installed:

  python scripts/jax_to_torch.py --folder runs/X [--checkpoint model_best]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def convert(folder: str | pathlib.Path, checkpoint: str = "model_best") -> pathlib.Path:
    import torch

    from pointnet2_scannet_tpu.engine.checkpoint import restore_params_only
    from pointnet2_scannet_tpu_torch.config import RunConfig
    from pointnet2_scannet_tpu_torch.engine.checkpoint import save_state_dict
    from pointnet2_scannet_tpu_torch.engine.export import run_kind
    from pointnet2_scannet_tpu_torch.engine.shape_runs import model_from_flat_config
    from pointnet2_scannet_tpu_torch.models.convert import state_dict_from_jax
    from pointnet2_scannet_tpu_torch.models.pointnet2 import get_model

    folder = pathlib.Path(folder)
    raw = json.loads((folder / "config.json").read_text())
    if run_kind(raw) == "semseg":
        cfg = RunConfig.load(folder / "config.json")
        model = get_model(
            num_classes=cfg.model.num_classes,
            is_msg=cfg.model.is_msg,
            input_channels=cfg.data.input_channels,
            use_xyz=cfg.model.use_xyz,
            bn=cfg.model.bn,
        )
    else:
        model = model_from_flat_config(raw)
    state = state_dict_from_jax(restore_params_only(folder, checkpoint), model.spec)
    # strict load: every tensor lands and every shape matches the port model
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return save_state_dict(folder, checkpoint, state)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--folder", type=str, required=True, help="JAX run output dir")
    p.add_argument("--checkpoint", type=str, default="model_best")
    args = p.parse_args(argv)
    path = convert(args.folder, args.checkpoint)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
