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

--trace DIR writes a torch.profiler trace (Chrome / TensorBoard format: host
activity and, on a GPU, the card's kernels) of one train epoch into DIR, the
second when there is one. The JAX package's execution flags that have no
counterpart here yet raise NotImplementedError naming their ROADMAP item;
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
    ("num_devices", lambda v: v is not None and v > 1, "data parallelism over several devices", 12),
    ("tp", lambda v: v is not None and v > 1, "tensor parallelism", 12),
    ("dist_coordinator", lambda v: v is not None, "multi-host training", 12),
    ("dist_nprocs", lambda v: v != 1, "multi-host training", 12),
    ("dist_pid", lambda v: v != 0, "multi-host training", 12),
    ("dist_auto", lambda v: v, "multi-host training", 12),
)


def check_ported(args) -> None:
    for flag, is_set, what, item in _UNPORTED:
        if is_set(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag}: {what} is not ported yet (ROADMAP queue 1, item {item})"
            )


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


def make_stores(cfg):
    from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_store

    if cfg.train.synthetic:
        n = cfg.train.synthetic_scenes
        return make_synthetic_store(n, seed=0), make_synthetic_store(max(n // 4, 1), seed=1000)
    train_ids = [l.strip() for l in open(cfg.paths.train_list) if l.strip()]
    val_ids = [l.strip() for l in open(cfg.paths.val_list) if l.strip()]
    if cfg.train.debug:  # train and validate on one scene
        train_ids = train_ids[:1]
        val_ids = train_ids
    mv = cfg.paths.multiview_h5 if cfg.data.use_multiview else None
    make = lambda ids: SceneStore.from_npy_dir(  # noqa: E731
        ids, cfg.paths.preprocessed_dir, mv, is_weighting=cfg.data.is_weighting
    )
    return make(train_ids), make(val_ids)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    return device


def train(args) -> tuple[pathlib.Path, dict]:
    """Train (or resume) a run; returns (run dir, best val metrics)."""
    check_ported(args)
    if args.device_store and args.no_device_store:
        raise SystemExit("--device_store and --no_device_store conflict")
    device = _device(args.device)
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
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        if args.tag:
            stamp += "_" + args.tag.upper()
        output_dir = pathlib.Path(cfg.paths.output_root) / stamp
        output_dir.mkdir(parents=True, exist_ok=True)

    train_store, val_store = make_stores(cfg)
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
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(seed))
    solver = solver_cls(model, train_ds, val_ds, cfg, output_dir, device=device, trace_dir=args.trace)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"device: {device} ({name}), {len(solver.train_loader)} steps per epoch, {step}, "
          f"compute dtype {cfg.model.compute_dtype}", flush=True)
    if solver.device_store:
        rows, width = solver.store["points"].shape
        print(f"device_store: {rows} rows x {width} on {device}, flattened in "
              f"{solver.store_flatten_s:.2f} s, uploaded in {solver.store_upload_s:.2f} s", flush=True)
    info = {
        **vars(args),
        "num_train_scenes": len(train_store),
        "num_val_scenes": len(val_store),
        "num_params": sum(p.numel() for p in model.parameters()),
    }
    (output_dir / "info.json").write_text(json.dumps(info, indent=2, default=str))

    start_epoch = solver.resume() if args.resume else 0
    print(f"training -> {output_dir} (from epoch {start_epoch})", flush=True)
    best = solver(start_epoch=start_epoch)
    print("best:", best, flush=True)
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
                   help="1 only; more devices are ROADMAP item 12")
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
    p.add_argument("--dist_coordinator", type=str, default=None, help="not ported yet (ROADMAP item 12)")
    p.add_argument("--dist_nprocs", type=int, default=1, help="1 only (ROADMAP item 12)")
    p.add_argument("--dist_pid", type=int, default=0, help="0 only (ROADMAP item 12)")
    p.add_argument("--dist_auto", action="store_true", help="not ported yet (ROADMAP item 12)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


if __name__ == "__main__":
    train(parse_args())
