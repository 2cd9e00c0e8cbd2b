"""Training CLI of the PyTorch + CUDA port (pointnet2_scannet_tpu_torch).

The port's counterpart of scripts/train.py, with its flags: chunked
semantic-segmentation training of the SSG model, or of the MSG model with
--use_msg, or whole-scene training with --use_wholescene (one optimizer
update per scene, gradients accumulated over micro-batches of --batch_size
columns), on --device (the hand-written CUDA kernels on a GPU, their plain
PyTorch versions on the CPU). --device_store trains chunks from a scene
store uploaded to the device once (each step gathers its batch there).
--bf16 computes in bfloat16 (the parameters, optimizer state and
checkpoints stay float32; the run dir's config.json records the dtype, and
infer_torch.py, eval_torch.py and visualize_torch.py serve it in bfloat16).
Writes
<output_root>/<timestamp>_<TAG>/ with config.json, info.json, model_best.pt
and model_last.pt (state_dicts that scripts/infer_torch.py serves), their
.train.pt / .meta.json resume state, tensorboard/all_scalars.json and
best.txt.

  python scripts/train_torch.py --synthetic --use_color --use_normal --device cuda
  python scripts/train_torch.py --synthetic --use_color --use_normal --use_msg
  python scripts/train_torch.py --synthetic --use_color --use_normal --use_wholescene
  python scripts/train_torch.py --synthetic --use_color --use_normal --device_store
  python scripts/train_torch.py --synthetic --use_color --use_normal --bf16
  python scripts/train_torch.py --synthetic --synthetic_scenes 4 --npoints 256 \\
      --batch_size 4 --epoch 2 --device cpu
  python scripts/train_torch.py --resume outputs/<run> --epoch 4

Data parallelism, one rank a device (the global --batch_size divides among
the ranks; BatchNorm statistics, gradients, loss and metrics are summed over
them, so a step applies the single-process gradient of the global batch):
--num_devices N spawns N ranks on this host (NCCL, one card each; gloo CPU
ranks with --device cpu); --dist_coordinator host:port --dist_nprocs N
--dist_pid P joins ranks started by hand on several hosts, --dist_auto the
ranks of torchrun or SLURM (env://). Only rank 0 prints and writes the run
dir; a resume restores every rank from it.

  python scripts/train_torch.py --synthetic --use_color --use_normal --num_devices 4
  python scripts/train_torch.py --synthetic --synthetic_scenes 8 --npoints 256 \\
      --batch_size 4 --epoch 2 --device cpu --num_devices 2
  torchrun --nproc_per_node 4 scripts/train_torch.py --synthetic --dist_auto

--trace DIR writes a torch.profiler trace (Chrome / TensorBoard format: host
activity and, on a GPU, the card's kernels) of one train epoch into DIR, the
second when there is one. The JAX package's execution flags that have no
counterpart here yet (--tp) raise NotImplementedError naming their ROADMAP item;
--fused_steps is recorded and the port runs one step per batch, the same
math per step.

  python scripts/train_torch.py --synthetic --use_color --use_normal --epoch 2 --trace /tmp/trace
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# flag -> (is it set?, what it asks for, ROADMAP queue 1 item)
_UNPORTED = (
    ("tp", lambda v: v is not None and v > 1, "tensor parallelism (the dp x tp mesh)", 12),
)


def check_ported(args) -> None:
    for flag, is_set, what, item in _UNPORTED:
        if is_set(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag}: {what} is not ported yet (ROADMAP queue 1, item {item})"
            )


def main(args):
    """The CLI: train in this process, or spawn --num_devices ranks on this
    host and train in each (returns None then: the run dir is rank 0's)."""
    from pointnet2_scannet_tpu_torch.parallel.distributed import cli_ranks, spawn_cli

    check_ported(args)
    n = cli_ranks(args)
    if n == 1:
        return train(args)
    spawn_cli(train, args, n)
    return None


def build_config(args):
    from pointnet2_scannet_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        PathConfig,
        RunConfig,
        TrainConfig,
    )

    return RunConfig(
        tag=args.tag,
        paths=PathConfig(
            preprocessed_dir=args.data_dir,
            multiview_h5=args.multiview_h5,
            output_root=args.output_root,
            train_list=args.train_list,
            val_list=args.val_list,
        ),
        data=DataConfig(
            npoints=args.npoints,
            is_weighting=not args.no_weighting,
            use_color=args.use_color,
            use_normal=args.use_normal,
            use_multiview=args.use_multiview,
        ),
        model=ModelConfig(
            is_msg=args.use_msg,
            use_xyz=not args.no_xyz,
            bn=not args.no_bn,
            compute_dtype="bfloat16" if args.bf16 else "float32",
        ),
        train=TrainConfig(
            batch_size=args.batch_size,
            epochs=args.epoch if args.epoch is not None else 500,
            lr=args.lr,
            weight_decay=args.wd,
            decay_step=args.ds,
            decay_factor=args.df,
            verbose=args.verbose if args.verbose is not None else 10,
            seed=args.seed,
            no_weighting=args.no_weighting,
            num_devices=args.num_devices,
            tp=args.tp if args.tp is not None else 1,
            shuffle=args.shuffle,
            device_store=args.device_store,
            fused_steps=args.fused_steps,
            wholescene=args.use_wholescene,
            synthetic=args.synthetic,
            synthetic_scenes=args.synthetic_scenes,
            debug=args.debug,
        ),
    )


def make_stores(cfg, ctx):
    """(train store, val store): this rank's scene shards in a chunked
    data-parallel run (the class weights the whole split's), every scene
    otherwise (whole-scene ranks walk the same scenes)."""
    from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_store

    shard = ctx.num_processes > 1 and not cfg.train.wholescene
    if cfg.train.synthetic:
        n = cfg.train.synthetic_scenes
        stores = make_synthetic_store(n, seed=0), make_synthetic_store(max(n // 4, 1), seed=1000)
        if not shard:
            return stores
        for name, store in zip(("train", "val"), stores):
            _warn_dropped(ctx, len(store), name)
        return tuple(s.shard(ctx.process_id, ctx.num_processes) for s in stores)
    train_ids = [l.strip() for l in open(cfg.paths.train_list) if l.strip()]
    val_ids = [l.strip() for l in open(cfg.paths.val_list) if l.strip()]
    if cfg.train.debug:  # train and validate on one scene
        train_ids = train_ids[:1]
        val_ids = train_ids
    mv = cfg.paths.multiview_h5 if cfg.data.use_multiview else None
    if shard:
        for name, ids in (("train", train_ids), ("val", val_ids)):
            _warn_dropped(ctx, len(ids), name)
        make = lambda ids: SceneStore.from_npy_dir_sharded(  # noqa: E731
            ids, cfg.paths.preprocessed_dir, mv, process_id=ctx.process_id,
            num_processes=ctx.num_processes, is_weighting=cfg.data.is_weighting, ctx=ctx,
        )
    else:
        make = lambda ids: SceneStore.from_npy_dir(  # noqa: E731
            ids, cfg.paths.preprocessed_dir, mv, is_weighting=cfg.data.is_weighting
        )
    return make(train_ids), make(val_ids)


def _warn_dropped(ctx, count: int, name: str) -> None:
    if count % ctx.num_processes:
        ctx.say(f"data parallel: dropping {count % ctx.num_processes} trailing {name} scene(s) so that "
                f"every rank holds as many", flush=True)


def train(args, ctx=None) -> tuple[pathlib.Path, dict]:
    """Train (or resume) a run; returns (run dir, best val metrics). ctx: this
    rank's parallel.ProcessContext; None joins the ranks that the --dist_*
    flags name (or none)."""
    check_ported(args)
    if args.device_store and args.no_device_store:
        raise SystemExit("--device_store and --no_device_store conflict")
    from pointnet2_scannet_tpu_torch.parallel.distributed import cli_context, cli_ranks, shutdown

    if ctx is not None:
        return _train(args, ctx)
    if cli_ranks(args) > 1:
        raise ValueError("--num_devices above 1: main() spawns the ranks, and train() runs one")
    ctx = cli_context(args)
    out = _train(args, ctx)
    shutdown(ctx)  # after every rank is done with the coordinator's files
    return out


def _train(args, ctx) -> tuple[pathlib.Path, dict]:
    import torch

    from pointnet2_scannet_tpu_torch.config import RunConfig
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset
    from pointnet2_scannet_tpu_torch.engine.solver import Solver, WholeSceneSolver
    from pointnet2_scannet_tpu_torch.models import model_from_config

    if args.resume:
        output_dir = pathlib.Path(args.resume)
        cfg = RunConfig.load(output_dir / "config.json")
        # the run's mode comes from its config.json, never from retyped flags
        for flag, saved in (
            ("use_wholescene", cfg.train.wholescene),
            ("synthetic", cfg.train.synthetic),
            ("debug", cfg.train.debug),
        ):
            if getattr(args, flag) and not saved:
                raise SystemExit(
                    f"--{flag} passed but the resumed run was not a {flag} run "
                    "(config.json disagrees)"
                )
        # execution flags may change at a resume: --epoch extends the run
        overrides = {}
        if args.num_devices is not None or ctx.num_processes > 1:
            overrides["num_devices"] = ctx.num_processes
        if args.verbose is not None:
            overrides["verbose"] = args.verbose
        if args.device_store:  # the same math as the host path
            overrides["device_store"] = True
        elif args.no_device_store:
            overrides["device_store"] = False
        if args.epoch is not None:
            overrides["epochs"] = max(args.epoch, cfg.train.epochs)
        if overrides:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))
    else:
        cfg = build_config(args)
        if ctx.num_processes > 1:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_devices=ctx.num_processes))
        stamp = ctx.broadcast_object(time.strftime("%Y-%m-%d_%H-%M-%S"))  # the coordinator's
        if args.tag:
            stamp += "_" + args.tag.upper()
        output_dir = pathlib.Path(cfg.paths.output_root) / stamp
        if ctx.is_coordinator:  # no other rank writes the run dir
            output_dir.mkdir(parents=True, exist_ok=True)

    train_store, val_store = make_stores(cfg, ctx)
    seed = cfg.train.seed
    if cfg.train.wholescene:  # one gradient-accumulated update per scene
        train_ds = WholeSceneDataset(train_store, cfg.data, seed=seed)
        val_ds = WholeSceneDataset(val_store, cfg.data, seed=seed + 1)
        solver_cls, step = WholeSceneSolver, "one update per scene"
    else:
        train_ds = ChunkedSceneDataset(train_store, cfg.data, phase="train", seed=seed)
        val_ds = ChunkedSceneDataset(val_store, cfg.data, phase="val", seed=seed + 1)
        solver_cls = Solver
        step = f"one step per batch (fused_steps {cfg.train.fused_steps} recorded)"
    # every rank draws the same initial weights
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(seed), bn_group=ctx.group)
    device = ctx.device
    solver = solver_cls(model, train_ds, val_ds, cfg, output_dir, device=device, trace_dir=args.trace,
                        process_ctx=ctx)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    ctx.say(f"device: {device} ({name}), {len(solver.train_loader)} steps per epoch, {step}, "
            f"compute dtype {cfg.model.compute_dtype}", flush=True)
    ctx.say(f"parallel strategy: {solver.parallel_strategy} (mesh size {ctx.num_processes}, "
            f"processes {ctx.num_processes})", flush=True)
    if solver.device_store:
        rows, width = solver.store["points"].shape
        print(f"device_store: {rows} rows x {width} on {device}, flattened in "
              f"{solver.store_flatten_s:.2f} s, uploaded in {solver.store_upload_s:.2f} s", flush=True)
    if ctx.is_coordinator:
        info = {
            **vars(args),
            "num_train_scenes": len(train_store),
            "num_val_scenes": len(val_store),
            "num_params": sum(p.numel() for p in model.parameters()),
        }
        (output_dir / "info.json").write_text(json.dumps(info, indent=2, default=str))

    start_epoch = solver.resume() if args.resume else 0
    ctx.say(f"training -> {output_dir} (from epoch {start_epoch})", flush=True)
    best = solver(start_epoch=start_epoch)
    ctx.say("best:", best, flush=True)
    return output_dir, best


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tag", type=str, default="", help="run tag for the output dir")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epoch", type=int, default=None,
                   help="epochs to train (default 500); at --resume, extends the run")
    p.add_argument("--verbose", type=int, default=None,
                   help="iters between reports (default 10; overridable at --resume)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--ds", type=int, default=100, help="lr decay step (epochs)")
    p.add_argument("--df", type=float, default=0.7, help="lr decay factor")
    p.add_argument("--npoints", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true", help="train on a single scene")
    p.add_argument("--no_weighting", action="store_true")
    p.add_argument("--no_bn", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype for the pointwise MLPs and the grouping (params stay f32)")
    p.add_argument("--no_xyz", action="store_true")
    p.add_argument("--use_msg", action="store_true", help="the multi-scale-grouping model")
    p.add_argument("--use_wholescene", action="store_true",
                   help="one optimizer update per whole scene, gradients accumulated over "
                   "micro-batches of --batch_size columns")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks to spawn on this host, one device each (NCCL between "
                   "cards, gloo between CPU ranks with --device cpu); the global --batch_size "
                   "divides among them")
    p.add_argument("--tp", type=int, default=None, help="1 only (ROADMAP item 12)")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace (Chrome/TensorBoard format) of one train "
                   "epoch into DIR: the second epoch when there is one, so that the first's "
                   "warm-up stays out of the steady-state timeline")
    p.add_argument("--shuffle", action="store_true",
                   help="shuffle scene order across train batches each epoch")
    p.add_argument("--device_store", action="store_true",
                   help="chunked training from a scene store uploaded to the device once: each "
                   "step sends only store rows and augmentation parameters (falls back to the "
                   "host path with a WARNING where the store cannot serve); at --resume, "
                   "overrides the saved setting")
    p.add_argument("--no_device_store", action="store_true",
                   help="at --resume: train on the host path although the saved run used "
                   "--device_store")
    p.add_argument("--fused_steps", type=int, default=8,
                   help="recorded in config.json; the port runs one step per batch "
                   "(the same math per step)")
    p.add_argument("--data_dir", type=str, default="data/preprocessed_scenes")
    p.add_argument("--multiview_h5", type=str, default="data/enet_feats.hdf5")
    p.add_argument("--train_list", type=str, default="data/scannetv2_train.txt")
    p.add_argument("--val_list", type=str, default="data/scannetv2_val.txt")
    p.add_argument("--output_root", type=str, default="outputs")
    p.add_argument("--synthetic", action="store_true", help="use generated scenes")
    p.add_argument("--synthetic_scenes", type=int, default=8)
    p.add_argument("--resume", type=str, default=None,
                   help="run output dir to resume from (restores the full train state)")
    p.add_argument("--dist_coordinator", type=str, default=None,
                   help="host:port of rank 0, the same on every rank of a multi-host run")
    p.add_argument("--dist_nprocs", type=int, default=1, help="ranks of the multi-host run")
    p.add_argument("--dist_pid", type=int, default=0, help="this process's rank")
    p.add_argument("--dist_auto", action="store_true",
                   help="join the ranks of torchrun or SLURM (env://: MASTER_ADDR, MASTER_PORT, "
                   "WORLD_SIZE, RANK)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
