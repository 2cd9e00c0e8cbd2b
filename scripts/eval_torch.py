"""Whole-scene evaluation with the PyTorch + CUDA port (pointnet2_scannet_tpu_torch).

The port's counterpart of scripts/eval.py: load a run dir's model (its flags
come from config.json, never retyped), tile every val scene into 1.5 m
columns, stream them through WholeSceneEvaluator on --device (the
hand-written CUDA kernels on a GPU, their plain PyTorch versions on the
CPU), print the global metrics (point accuracy, per-class point accuracy,
voxel accuracy, per-class voxel accuracy, calibrated voxel accuracy, point
and voxel mIoU) and the per-class table, and write them to
<folder>/eval_report.txt.

  python scripts/eval_torch.py --folder runs/X --synthetic --synthetic_scenes 4
  python scripts/eval_torch.py --folder runs/X --data_dir D --val_list L --device cpu

The run dir holds config.json and <checkpoint>.pt (scripts/train_torch.py
writes both; scripts/jax_to_torch.py converts a JAX run dir).

Data-parallel evaluation: --num_devices N spawns N ranks on this host (one
card each; CPU ranks with --device cpu), --dist_coordinator host:port
--dist_nprocs N --dist_pid P (or --dist_auto) joins ranks started by hand.
Each rank evaluates its own strided shard of the scenes; rank 0 merges the
per-scene results, prints the report and writes eval_report.txt.

  python scripts/eval_torch.py --folder runs/X --synthetic --synthetic_scenes 8 --num_devices 2
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

def load(args, scene_ids=None, ctx=None):
    """(run dir, WholeSceneDataset, WholeSceneEvaluator) for the run dir,
    scenes and device that args name; scene_ids, where given, replace the
    val list. ctx: a data-parallel rank's parallel.ProcessContext, whose
    strided shard of the scenes the dataset holds (every scene covered:
    shards may differ by one); None: every scene, on --device."""
    import torch

    from pointnet2_scannet_tpu_torch.data import SceneStore, WholeSceneDataset, make_synthetic_store
    from pointnet2_scannet_tpu_torch.engine.evaluator import WholeSceneEvaluator
    from pointnet2_scannet_tpu_torch.engine.export import load_run_model
    from pointnet2_scannet_tpu_torch.parallel import ProcessContext

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    ctx = ctx or ProcessContext.single(device)
    run_dir = pathlib.Path(args.folder)
    model, cfg = load_run_model(run_dir, args.checkpoint)
    if isinstance(cfg, dict):
        raise SystemExit(f"{run_dir} is a shape-family run: evaluate it with scripts/eval_shapes_torch.py")
    if args.synthetic:
        store = make_synthetic_store(args.synthetic_scenes, seed=1000).shard(
            ctx.process_id, ctx.num_processes, equalize=False)
    else:
        if scene_ids is None:
            list_path = pathlib.Path(args.val_list or cfg.paths.val_list)
            scene_ids = [l.strip() for l in list_path.read_text().splitlines() if l.strip()]
        store = SceneStore.from_npy_dir_sharded(
            scene_ids,
            args.data_dir or cfg.paths.preprocessed_dir,
            cfg.paths.multiview_h5 if cfg.data.use_multiview else None,
            process_id=ctx.process_id,
            num_processes=ctx.num_processes,
            is_weighting=cfg.data.is_weighting,
            equalize=False,
            ctx=ctx,
        ) if ctx.num_processes > 1 else SceneStore.from_npy_dir(
            scene_ids,
            args.data_dir or cfg.paths.preprocessed_dir,
            cfg.paths.multiview_h5 if cfg.data.use_multiview else None,
            is_weighting=cfg.data.is_weighting,
        )
    evaluator = WholeSceneEvaluator(
        model,
        device=ctx.device,
        batch_size=args.batch_size,
        num_classes=cfg.model.num_classes,
        ring_slots=args.eval_ring,
        queue_depth=args.eval_depth,
    )
    return run_dir, WholeSceneDataset(store, cfg.data, seed=0), evaluator


def run(entry, args):
    """entry(args, ctx) in this process, or on each of --num_devices spawned
    ranks (returns None then)."""
    from pointnet2_scannet_tpu_torch.parallel.distributed import cli_context, cli_ranks, shutdown, spawn_cli

    n = cli_ranks(args)
    if n > 1:
        spawn_cli(entry, args, n)
        return None
    ctx = cli_context(args)
    out = entry(args, ctx)
    shutdown(ctx)
    return out


def evaluate(args):
    """Evaluate every scene; print and write the report, and return it (the
    coordinator's; None on the other ranks)."""
    return run(evaluate_rank, args)


def evaluate_rank(args, ctx):
    from pointnet2_scannet_tpu_torch.engine.evaluator import merge_scene_results

    run_dir, dataset, evaluator = load(args, ctx=ctx)
    if ctx.num_processes == 1:
        report = evaluator.evaluate(dataset)
    else:
        local = evaluator.evaluate(dataset).scenes if len(dataset) else []
        report = evaluator.aggregate(merge_scene_results(ctx, local, evaluator.num_classes))
        if not ctx.is_coordinator:
            return None
    print()
    print(report.format_table())
    (run_dir / "eval_report.txt").write_text(report.format_table())
    return report


def add_flags(p: argparse.ArgumentParser, synthetic_scenes: int) -> None:
    """The flags eval_torch.py and visualize_torch.py share."""
    p.add_argument("--folder", type=str, required=True, help="run output dir")
    p.add_argument("--checkpoint", type=str, default="model_best")
    p.add_argument("--batch_size", type=int, default=32, help="columns per forward")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--val_list", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_scenes", type=int, default=synthetic_scenes)
    p.add_argument("--eval_ring", type=int, default=None,
                   help="resident scene slots in the device ring (default: sized from the "
                   "dataset so steady evaluation never flushes; costs device memory per slot)")
    p.add_argument("--eval_depth", type=int, default=2, help="device batches in flight")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain versions)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks to spawn on this host, one device each; each takes its "
                   "shard of the scenes")
    p.add_argument("--dist_coordinator", type=str, default=None,
                   help="host:port of rank 0, the same on every rank of a multi-host run")
    p.add_argument("--dist_nprocs", type=int, default=1, help="ranks of the multi-host run")
    p.add_argument("--dist_pid", type=int, default=0, help="this process's rank")
    p.add_argument("--dist_auto", action="store_true",
                   help="join the ranks of torchrun or SLURM (env://)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_flags(p, synthetic_scenes=2)
    return p.parse_args(argv)


if __name__ == "__main__":
    evaluate(parse_args())
