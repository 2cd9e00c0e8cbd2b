"""Scene inference with the PyTorch + CUDA port (pointnet2_scannet_tpu_torch).

The port's counterpart of scripts/infer.py: tile each scene into columns,
run the eval-mode forward of the run's model (SSG or MSG, as its
config.json says) on --device (the hand-written CUDA kernels on a GPU, their
plain PyTorch versions on the CPU), argmax to labels, dedup the evaluated
points, and write <out>/<sid>_pred.npy with (M, 4) [x y z label] rows, plus
a palette PLY with --write_ply.

  python scripts/infer_torch.py --folder runs/X --synthetic --device cuda
  python scripts/infer_torch.py --folder runs/X --data_dir D --scene_list L

  # a torch.export artifact of the eval forward (weights included), traced
  # on the first of --platforms (default: --device), then served from it
  python scripts/infer_torch.py --folder runs/X --export m.pt2 [--platforms cpu cuda]
  python scripts/infer_torch.py --folder runs/X --from_artifact m.pt2 --synthetic

--export takes a run dir of any family: semantic segmentation, and the
shape families of scripts/train_cls_torch.py ((B,) class ids) and
train_partseg_torch.py ((B, N) part ids, the category one-hot in the
input's last channels); scene inference serves semantic-segmentation runs
only. An artifact fixes --batch_size, --npoints and --emit when it is exported.
It calls the port's kernels (pn2:: ops), so serving from it imports this
package and builds the kernels on the card. --num_devices N round-robins
the batches over N cards (from the run dir, through an artifact exported
in-process); on the CPU the one CPU device takes every batch.

The run dir holds config.json and <checkpoint>.pt (a port state_dict; make
one from a JAX run dir with scripts/jax_to_torch.py). Scene .npy files may be
the preprocessed (N, 11) layout or a shorter unlabeled prefix of it; missing
trailing columns are zero-padded, and a cloud missing feature columns the
run reads is rejected.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _load_store(args, cfg):
    from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_store

    if args.synthetic:
        return make_synthetic_store(args.synthetic_scenes, seed=1000)
    list_path = pathlib.Path(args.scene_list or cfg.paths.val_list)
    scene_ids = [l.strip() for l in list_path.read_text().splitlines() if l.strip()]
    store = SceneStore.from_npy_dir(
        scene_ids,
        args.data_dir or cfg.paths.preprocessed_dir,
        multiview_h5=(args.multiview_h5 or cfg.paths.multiview_h5)
        if cfg.data.use_multiview
        else None,
        is_weighting=False,
    )
    required = 9 if cfg.data.use_normal else (6 if cfg.data.use_color else 3)
    for sid, arr in store.scenes.items():
        if arr.ndim != 2 or arr.shape[1] < required:
            raise SystemExit(
                f"{sid}.npy has shape {arr.shape}; this run reads the first "
                f"{required} columns of the [xyz rgb normal instance label] "
                "layout (N, 11) — re-export the scene with those columns"
            )
        if arr.shape[1] < 11:
            pad = np.zeros((len(arr), 11 - arr.shape[1]), arr.dtype)
            store.scenes[sid] = np.concatenate([arr, pad], axis=1)
    return store


def _devices(args) -> list[str]:
    """--num_devices devices of --device's type: cards 0..N-1, or the CPU
    N times."""
    import torch

    n = args.num_devices or 1
    kind = torch.device(args.device).type
    if kind != "cuda":
        return [kind] * n
    if n > torch.cuda.device_count():
        raise SystemExit(f"--num_devices {n} but only {torch.cuda.device_count()} devices are visible")
    return [f"cuda:{k}" for k in range(n)] if n > 1 else [args.device]


def export(args, run_dir: pathlib.Path) -> dict:
    """--export: trace the run's eval forward and save the artifact."""
    import torch

    from pointnet2_scannet_tpu_torch.engine.export import export_run, save_exported

    platforms = args.platforms or [torch.device(args.device).type]
    t0 = time.perf_counter()
    exported = export_run(run_dir, checkpoint=args.checkpoint, batch_size=args.batch_size or 32,
                          npoints=args.npoints, emit=args.emit, platforms=platforms)
    export_s = time.perf_counter() - t0
    path = save_exported(exported, args.export)
    stats = {"export_s": export_s, "nodes": exported.num_nodes, "mb": path.stat().st_size / 1e6,
             "input": exported.in_shape, "platforms": list(exported.platforms)}
    print(f"exported {args.checkpoint} -> {path} ({stats['mb']:.1f} MB, input {stats['input']}, "
          f"emit={args.emit}, platforms={stats['platforms']}; traced in {export_s:.1f} s, "
          f"{stats['nodes']} graph nodes)")
    return stats


def infer(args) -> dict:
    """Serve every scene, or export an artifact with --export; returns counts
    and times of the run."""
    import dataclasses

    from pointnet2_scannet_tpu_torch.config import PALETTE, RunConfig
    from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset
    from pointnet2_scannet_tpu_torch.engine.export import (
        Predictor,
        ServingPredictor,
        export_run,
        run_kind,
    )
    from pointnet2_scannet_tpu_torch.engine.metrics import filter_points

    t_start = time.perf_counter()
    run_dir = pathlib.Path(args.folder)
    if args.export:  # every family
        return export(args, run_dir)
    kind = run_kind(json.loads((run_dir / "config.json").read_text()))
    if kind != "semseg":
        raise SystemExit(
            f"--folder points at a {kind} run: scene inference is a semantic-"
            "segmentation flow. Shape-family runs export serving artifacts "
            "with --export (all three families) and evaluate with "
            "scripts/eval_shapes_torch.py; serve artifacts programmatically via "
            "engine.export.ServingPredictor."
        )
    cfg = RunConfig.load(run_dir / "config.json")
    devices = _devices(args)
    if args.from_artifact:
        if args.batch_size is not None or args.npoints is not None or args.emit != "labels":
            print("note: --batch_size/--npoints/--emit are fixed in the artifact at export "
                  f"time; the values saved in {args.from_artifact} are used")
        predictor = ServingPredictor.from_artifact(args.from_artifact, devices=devices)
    elif len(devices) > 1:
        predictor = ServingPredictor(
            export_run(run_dir, checkpoint=args.checkpoint, batch_size=args.batch_size or 32,
                       npoints=args.npoints, emit=args.emit, platforms=[devices[0].split(":")[0]]),
            devices=devices,
        )
    else:
        predictor = Predictor.from_run(
            run_dir,
            checkpoint=args.checkpoint,
            batch_size=args.batch_size or 32,
            npoints=args.npoints,
            emit=args.emit,
            device=args.device,
        )
    if predictor.channels != 3 + cfg.data.input_channels:
        raise SystemExit(
            f"artifact expects {predictor.channels} channels but the run's feature layout is "
            f"{3 + cfg.data.input_channels} (check use_color/use_normal/use_multiview)"
        )
    store = _load_store(args, cfg)
    data_cfg = dataclasses.replace(cfg.data, npoints=predictor.npoints)
    dataset = WholeSceneDataset(store, data_cfg, seed=0)

    out_dir = pathlib.Path(args.out or (run_dir / "infer"))
    out_dir.mkdir(parents=True, exist_ok=True)
    palette = np.asarray(PALETTE, np.uint8)
    stats = {"scenes": 0, "columns": 0, "points": 0, "predict_s": 0.0}
    for scene_id, (feats, labels, weights) in dataset.iter_scenes():
        t0 = time.perf_counter()
        preds = predictor.predict(feats)
        stats["predict_s"] += time.perf_counter() - t0
        stats["scenes"] += 1
        stats["columns"] += len(feats)
        stats["points"] += feats.shape[0] * feats.shape[1]
        if preds.ndim == 3:  # logits: reduce to labels here
            preds = np.argmax(preds, axis=-1)
        coords = feats[..., :3].reshape(-1, 3)
        flat = preds.reshape(-1).astype(np.int32)
        coords_u, preds_u, _, _ = filter_points(
            coords, flat, labels.reshape(-1), weights.reshape(-1)
        )
        np.save(
            out_dir / f"{scene_id}_pred.npy",
            np.concatenate([coords_u, preds_u[:, None].astype(np.float32)], axis=1),
        )
        if args.write_ply:
            from pointnet2_scannet_tpu_torch.utils.ply import write_ply_points

            colors = palette[np.clip(preds_u, 0, len(palette) - 1)]
            write_ply_points(out_dir / f"{scene_id}_pred.ply", coords_u, colors)
        print(f"{scene_id}: {len(coords_u)} points -> {out_dir / f'{scene_id}_pred.npy'}")
    stats["total_s"] = time.perf_counter() - t_start
    return stats


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--folder", type=str, required=True, help="run output dir")
    p.add_argument("--checkpoint", type=str, default="model_best")
    p.add_argument("--batch_size", type=int, default=None,
                   help="columns per forward (default 32; fixed in an artifact)")
    p.add_argument("--npoints", type=int, default=None,
                   help="column size (default: the run's training npoints)")
    p.add_argument("--export", type=str, default=None,
                   help="write the torch.export serving artifact here and exit")
    p.add_argument("--emit", choices=("labels", "logits"), default="labels")
    p.add_argument("--platforms", nargs="+", choices=("cpu", "cuda"), default=None,
                   help="where an --export artifact may run; traced on the first "
                   "(default: --device's type)")
    p.add_argument("--from_artifact", type=str, default=None,
                   help="serve from a saved artifact instead of the run dir's checkpoint")
    p.add_argument("--num_devices", type=int, default=None,
                   help="round-robin serving batches across this many cards "
                   "(batch-parallel, no collectives; default 1)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain versions)")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--scene_list", type=str, default=None)
    p.add_argument("--multiview_h5", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_scenes", type=int, default=1)
    p.add_argument("--out", type=str, default=None,
                   help="prediction output dir (default <folder>/infer)")
    p.add_argument("--write_ply", action="store_true")
    return p.parse_args(argv)


if __name__ == "__main__":
    infer(parse_args())
