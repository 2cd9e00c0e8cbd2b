"""Prediction PLYs with the PyTorch + CUDA port (pointnet2_scannet_tpu_torch).

The port's counterpart of scripts/visualize.py: whole-scene prediction of
one scene (--scene_id) or of every val scene, through WholeSceneEvaluator
on --device, then coordinate dedup and palette colours, written as ascii
PLY to <folder>/preds/<scene_id>.ply. The flags are scripts/eval_torch.py's:
with --num_devices or --dist_* each rank predicts and writes its own
strided shard of the scenes.

  python scripts/visualize_torch.py --folder runs/X --synthetic
  python scripts/visualize_torch.py --folder runs/X --data_dir D --scene_id scene0011_00 --device cpu
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import eval_torch  # noqa: E402


def visualize(args) -> list:
    """Write one PLY a scene; returns (path, points) per scene (of rank 0's
    scenes in a data-parallel run, which returns None with --num_devices)."""
    return eval_torch.run(visualize_rank, args)


def visualize_rank(args, ctx) -> list:
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import PALETTE
    from pointnet2_scannet_tpu_torch.engine.metrics import filter_points
    from pointnet2_scannet_tpu_torch.utils.ply import write_ply_points

    run_dir, dataset, evaluator = eval_torch.load(args, [args.scene_id] if args.scene_id else None, ctx)
    preds_dir = run_dir / "preds"
    preds_dir.mkdir(exist_ok=True)  # every rank's scenes go into the run dir
    palette = np.asarray(PALETTE, np.uint8)

    def write_scene(scene_id, coords, labels, weights, preds):
        coords_u, preds_u, _, _ = filter_points(
            coords.reshape(-1, 3), preds.reshape(-1), labels.reshape(-1), weights.reshape(-1)
        )
        out = preds_dir / f"{scene_id}.ply"
        write_ply_points(out, coords_u, palette[np.clip(preds_u, 0, len(palette) - 1)])
        return out, len(coords_u)

    return evaluator.map_scenes(dataset, write_scene, progress=lambda r: print(f"wrote {r[0]} ({r[1]} points)"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene_id", type=str, default=None, help="one scene of --data_dir (default: the val list)")
    eval_torch.add_flags(p, synthetic_scenes=1)
    return p.parse_args(argv)


if __name__ == "__main__":
    visualize(parse_args())
