"""Preprocessing CLI of the PyTorch port: raw ScanNet scans -> per-scene
(N, 11) .npy arrays, the vertex normals computed on --device.

The flags of scripts/preprocess.py (the reference's
preprocessing/collect_scannet_scenes.py:81-104), plus --device. --visualize
<scene_id> writes a preprocessed scene as a PLY coloured by its labels
(preprocessing/visualize_prep_scene.py).

    python scripts/preprocess_torch.py --scans_dir data/scannet/scans \\
        --label_tsv data/scannetv2-labels.combined.tsv --output_dir data/preprocessed_scenes
    python scripts/preprocess_torch.py --device cpu ...   # without a card
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(args) -> list[str]:
    """Returns the scene ids preprocessed (none for --visualize)."""
    from pointnet2_scannet_tpu_torch.config import PALETTE
    from pointnet2_scannet_tpu_torch.data.scannet_prep import collect_scenes
    from pointnet2_scannet_tpu_torch.utils.ply import write_ply_points

    if args.visualize:
        scene = np.load(pathlib.Path(args.output_dir) / f"{args.visualize}.npy")
        palette = np.asarray(PALETTE, np.uint8)
        colors = palette[np.clip(scene[:, 10].astype(int), 0, len(palette) - 1)]
        out = pathlib.Path(args.output_dir) / f"{args.visualize}_gt.ply"
        write_ply_points(out, scene[:, :3], colors)
        print(f"wrote {out}")
        return []

    scene_ids = sorted(p.name for p in pathlib.Path(args.scans_dir).iterdir() if p.is_dir())
    if args.scene_list:
        with open(args.scene_list) as f:
            wanted = {line.strip() for line in f if line.strip()}
        scene_ids = [s for s in scene_ids if s in wanted]
    done = collect_scenes(args.scans_dir, scene_ids, args.label_tsv, args.output_dir, device=args.device)
    print(f"preprocessed {len(done)}/{len(scene_ids)} scenes -> {args.output_dir}")
    return done


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scans_dir", type=str, default="data/scannet/scans")
    p.add_argument("--label_tsv", type=str, default="data/scannetv2-labels.combined.tsv")
    p.add_argument("--output_dir", type=str, default="data/preprocessed_scenes")
    p.add_argument("--scene_list", type=str, default=None)
    p.add_argument("--visualize", type=str, default=None, help="scene id to dump as GT PLY")
    p.add_argument("--device", type=str, default="cuda", help="where the vertex normals are computed")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
