"""The shape families' runs: training and evaluating PointNet++
classification (cls) and part segmentation (partseg) on the synthetic
parametric shapes of data/shapes.py. The port's counterpart of the JAX
package's scripts/train_cls.py, train_partseg.py and eval_shapes.py, with
their flags, defaults and run-dir layout; scripts/train_cls_torch.py,
train_partseg_torch.py and eval_shapes_torch.py call it.

A run dir holds config.json (the flat flag namespace, plus shape_classes,
and num_parts for partseg, so that engine/export.run_kind tells the kinds
apart), info.json, model_last / model_best (gated on val accuracy for cls,
on the val part mIoU for partseg) in the port's .pt format with the
optimizer state (engine/checkpoint.py), and all_scalars.json. --resume
continues a run in place: its flags come from its config.json, except the
execution flags (--num_devices, --verbose, --device, --dist_*), and --epoch
may extend it. The steps are the segmentation engine's
(engine/train_state.train_step and eval_step): per-row cross-entropy on
(B, K) logits and (B,) labels for cls, per point for partseg, with no
row_mask (the shape batches have no padding rows).

Data: a fixed validation set drawn at seed + 10_000 without augmentation,
the train stream at seed (a resume draws a fresh stream at [seed,
start_epoch]), the evaluation's fresh stream at seed + 20_000.

Data parallelism on parallel/ (one rank a device, the global --batch_size
divided among them; BatchNorm statistics, gradients, loss and confusion
matrices over every rank, so a step applies the gradient of the global
batch). --num_devices N spawns N ranks on this host: they stand for the
JAX package's one process driving an N-device mesh, so every rank draws the
one global stream and takes its rows of each batch. --dist_* ranks stand
for the JAX package's processes: each draws its own train stream at [seed,
rank] (a resume: [seed, start_epoch, rank]) and its rows of the global
validation set. Only rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import PALETTE
from pointnet2_scannet_tpu_torch.data import shapes
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.checkpoint import load_state_dict, restore_checkpoint, save_checkpoint
from pointnet2_scannet_tpu_torch.engine.export import run_kind
from pointnet2_scannet_tpu_torch.engine.metrics import confusion_to_point_metrics, instance_part_miou
from pointnet2_scannet_tpu_torch.parallel import distributed as D
from pointnet2_scannet_tpu_torch.parallel.step import make_shardmap_eval_step, make_shardmap_train_step


@dataclasses.dataclass(frozen=True)
class Family:
    """What differs between the two trainers."""

    count_flag: str  # the flag that sets the class or category count
    count_help: str
    batch_size: int
    output_root: str
    best: str  # the val metric that gates model_best
    best_name: str


FAMILIES = {
    "cls": Family("classes", "number of shape classes (first K of data/shapes.SHAPE_CLASSES)",
                  32, "outputs_cls", "val_acc", "val acc"),
    "partseg": Family("categories", "number of shape categories (first K of data/shapes.SHAPE_CLASSES; "
                      "the part-label space is their global part-id union)",
                      16, "outputs_partseg", "val_part_miou", "val part mIoU"),
}


# ------------------------------------------------------------------ models


def model_from_flat_config(raw: dict, **kwargs) -> torch.nn.Module:
    """The cls or partseg model that a shape trainer's config.json names
    (classes or categories, use_msg, no_bn, bf16); kwargs (bn_group,
    device, generator) pass through."""
    from pointnet2_scannet_tpu_torch.models import get_cls_model, get_partseg_model

    common = dict(is_msg=bool(raw["use_msg"]), bn=not raw["no_bn"],
                  dtype=torch.bfloat16 if raw.get("bf16") else None, **kwargs)
    if run_kind(raw) == "partseg":
        categories = int(raw["categories"])
        num_parts = shapes.num_parts_total(categories)
        if "num_parts" in raw and int(raw["num_parts"]) != num_parts:
            raise ValueError(f"config.json says {raw['num_parts']} parts, its {categories} categories have "
                             f"{num_parts}")
        return get_partseg_model(num_parts, categories, **common)
    return get_cls_model(int(raw["classes"]), **common)


# ------------------------------------------------------------------- flags


def parse_args(kind: str, argv=None) -> argparse.Namespace:
    """The flags of the JAX package's train_cls.py / train_partseg.py, and
    --device."""
    fam = FAMILIES[kind]
    p = argparse.ArgumentParser(description=f"Train the PointNet++ {kind} family (engine/shape_runs.py).")
    p.add_argument("--tag", type=str, default="")
    p.add_argument(f"--{fam.count_flag}", type=int, default=8, help=fam.count_help)
    p.add_argument("--batch_size", type=int, default=fam.batch_size)
    p.add_argument("--epoch", type=int, default=None,
                   help="total epochs (default 20; on --resume the run's saved target, a larger value extends)")
    p.add_argument("--train_batches", type=int, default=50, help="batches per epoch")
    p.add_argument("--val_batches", type=int, default=8)
    p.add_argument("--npoints", type=int, default=1024)
    p.add_argument("--verbose", type=int, default=None,
                   help="iters between reports (default 0; on --resume the run's saved value)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--ds", type=int, default=10, help="lr decay step (epochs)")
    p.add_argument("--df", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_msg", action="store_true")
    p.add_argument("--no_bn", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks to spawn on this host, one device each (default 1; on --resume "
                   "the run's saved value)")
    p.add_argument("--output_root", type=str, default=fam.output_root)
    p.add_argument("--resume", type=str, default=None,
                   help="run dir to continue in place (flags from its config.json; --epoch may extend it)")
    p.add_argument("--dist_coordinator", type=str, default=None,
                   help="host:port of rank 0, the same on every rank of a multi-host run")
    p.add_argument("--dist_nprocs", type=int, default=1, help="ranks of the multi-host run")
    p.add_argument("--dist_pid", type=int, default=0, help="this process's rank")
    p.add_argument("--dist_auto", action="store_true", help="join the ranks of torchrun or SLURM (env://)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


_EXECUTION = ("device", "dist_coordinator", "dist_nprocs", "dist_pid", "dist_auto")


def resolve_args(args: argparse.Namespace) -> argparse.Namespace:
    """The run's flags. A resume takes its run's config.json (the
    no-retyped-flags rule) with this command's execution flags; --epoch
    may extend the run. Fails before anything changes if the run has no
    model_last checkpoint."""
    if args.resume:
        resume_dir = pathlib.Path(args.resume)
        if not (resume_dir / "model_last.pt").exists():
            raise FileNotFoundError(resume_dir / "model_last.pt")
        saved = json.loads((resume_dir / "config.json").read_text())
        epoch = int(saved["epoch"]) if args.epoch is None else max(args.epoch, int(saved["epoch"]))
        given = {k: getattr(args, k) for k in ("num_devices", "verbose") if getattr(args, k) is not None}
        execution = {k: getattr(args, k) for k in _EXECUTION}
        args = argparse.Namespace(**{k: v for k, v in saved.items() if k not in ("shape_classes", "num_parts")})
        args.resume, args.epoch = str(resume_dir), epoch
        vars(args).update(execution)
        vars(args).update(given)
    if args.epoch is None:
        args.epoch = 20
    if D.dist_flags_set(args):
        args.num_devices = None  # the ranks are the ones --dist_* names
    elif args.num_devices is None:
        args.num_devices = 1
    if args.verbose is None:
        args.verbose = 0
    return args


# -------------------------------------------------------------------- data


def _sampler(kind: str, count: int, npoints: int):
    """fn(rng, batch, augment) -> one numpy batch of the family."""
    draw = shapes.sample_cls_batch if kind == "cls" else shapes.sample_partseg_batch
    return lambda rng, b, augment=True: draw(rng, b, npoints, count, augment=augment)


def _device_batch(batch: dict, device) -> dict:
    """The step's tensors of a numpy batch (category stays on the host)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
            if k != "category"}


def _validate(kind: str, eval_step, model, batches, ctx, num_out: int, count: int) -> dict:
    """Every rank's rows of each global batch through the eval step: the
    confusion over the global batch, and for partseg the instance and
    category mIoU over every shape (the predictions of all ranks)."""
    cm = np.zeros((num_out, num_out), np.int64)
    cat_ious: dict[int, list[float]] = {}
    offsets, sizes = shapes.part_offsets(count), shapes.part_sizes(count)
    for batch in batches:
        out = eval_step(model, _device_batch(ctx.place_from_global(batch), ctx.device))
        cm += out["confusion"].cpu().numpy()
        if kind == "partseg":
            preds = ctx.all_rows(out["preds"].cpu().numpy())
            _, per_cat = instance_part_miou(preds, batch["labels"], batch["category"], offsets, sizes)
            for c, v in per_cat.items():
                cat_ious.setdefault(c, []).extend(v)
    if kind == "cls":
        return {"val_acc": float(np.trace(cm) / max(cm.sum(), 1)), "confusion": cm}
    m = confusion_to_point_metrics(cm)
    all_ious = [x for v in cat_ious.values() for x in v]
    return {
        "val_acc": m["point_acc"],
        "val_part_miou": m["point_miou"],
        # instance average: over every shape; category average: over the
        # categories of their shapes' means (the ShapeNet-part pair)
        "val_ins_miou": float(np.mean(all_ious)) if all_ious else 0.0,
        "val_cat_miou": float(np.mean([np.mean(v) for v in cat_ious.values()])) if cat_ious else 0.0,
        "confusion": cm,
        "per_cat": cat_ious,
    }


# ---------------------------------------------------------------- training


def main(kind: str, argv=None):
    """A trainer CLI: train in this process, or spawn --num_devices ranks on
    this host and train in each (returns None then)."""
    args = resolve_args(parse_args(kind, argv))
    entry = train_cls if kind == "cls" else train_partseg
    n = D.cli_ranks(args)
    if n == 1:
        return entry(args)
    D.spawn_cli(entry, args, n)
    return None


def train_cls(args, ctx=None):
    return train("cls", args, ctx)


def train_partseg(args, ctx=None):
    return train("partseg", args, ctx)


def train(kind: str, args, ctx=None) -> tuple[pathlib.Path, dict]:
    """Train (or resume) a run of resolved flags; returns (run dir, the last
    epoch's scalars with the best gating metric). ctx: this rank's
    ProcessContext; None joins the ranks --dist_* names (or none)."""
    if ctx is not None:
        return _train(kind, args, ctx)
    if D.cli_ranks(args) > 1:
        raise ValueError("--num_devices above 1: main() spawns the ranks, and train() runs one")
    ctx = D.cli_context(args)
    out = _train(kind, args, ctx)
    D.shutdown(ctx)
    return out


def _train(kind: str, args, ctx) -> tuple[pathlib.Path, dict]:
    fam = FAMILIES[kind]
    count = int(getattr(args, fam.count_flag))
    num_out = count if kind == "cls" else shapes.num_parts_total(count)
    if args.batch_size % ctx.num_processes:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible by {ctx.num_processes} ranks")
    extra = {"shape_classes": shapes.SHAPE_CLASSES[:count]}
    if kind == "partseg":
        extra["num_parts"] = num_out
    raw = {**vars(args), **extra}
    # every rank draws the same initial weights
    model = model_from_flat_config(raw, bn_group=ctx.group, device=ctx.device,
                                   generator=torch.Generator().manual_seed(args.seed))
    schedule = ts.make_lr_schedule(args.lr, args.ds, args.df, args.train_batches)
    state = ts.create_train_state(model, schedule, weight_decay=args.wd,
                                  seed=D.dropout_seed(args.seed + 1, ctx.process_id))
    train_step = make_shardmap_train_step(model, ctx.group, num_classes=num_out)
    eval_step = make_shardmap_eval_step(model, ctx.group, num_classes=num_out)
    strategy = (f"data parallel, {ctx.num_processes} ranks ({torch.distributed.get_backend(ctx.group)})"
                if ctx.group is not None else "single-device")

    resume_dir = pathlib.Path(args.resume) if args.resume else None
    if resume_dir is not None:
        output_dir = resume_dir  # continue in place
    else:
        stamp = ctx.broadcast_object(time.strftime("%Y-%m-%d_%H-%M-%S"))  # the coordinator's
        if args.tag:
            stamp += "_" + args.tag.upper()
        output_dir = pathlib.Path(args.output_root) / stamp
    config_json = json.dumps(raw, indent=2, default=str)
    if ctx.is_coordinator:
        output_dir.mkdir(parents=True, exist_ok=True)
        (output_dir / "config.json").write_text(config_json)
        info = {"parallel": strategy, "num_params": sum(p.numel() for p in model.parameters())}
        (output_dir / "info.json").write_text(json.dumps(info, indent=2))
    name = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "host"
    ctx.say(f"parallel strategy: {strategy}; device {ctx.device} ({name}), compute dtype "
            f"{'bfloat16' if args.bf16 else 'float32'}; training -> {output_dir}", flush=True)

    sample = _sampler(kind, count, args.npoints)
    # --num_devices ranks share the one stream of the JAX package's single
    # process; --dist_* ranks draw their own, as its processes do
    own_stream = ctx.num_processes > 1 and not (args.num_devices or 1) > 1
    rows = args.batch_size // ctx.num_processes if own_stream else args.batch_size
    rng = np.random.default_rng([args.seed, ctx.process_id] if own_stream else args.seed)
    val_rng = np.random.default_rng(args.seed + 10_000)
    # the fixed validation set, augmentation off: comparable across epochs
    val_batches = [sample(val_rng, args.batch_size, False) for _ in range(args.val_batches)]

    scalars: list[dict] = []
    best, start_epoch = -1.0, 0
    if resume_dir is not None:
        meta = restore_checkpoint(output_dir, "model_last", state, ctx.process_id)
        start_epoch = int(meta.get("epoch", -1)) + 1
        scal_path = output_dir / "all_scalars.json"
        if scal_path.exists():
            scalars = json.loads(scal_path.read_text())[:start_epoch]
        best_meta = output_dir / "model_best.meta.json"
        if best_meta.exists():
            best = float(json.loads(best_meta.read_text()).get("best", {}).get(fam.best, -1.0))
        # a fresh but deterministic train stream: the run's first epochs'
        # batches are not replayed (the validation set stays the run's own)
        rng = np.random.default_rng(
            [args.seed, start_epoch, ctx.process_id] if own_stream else [args.seed, start_epoch])
        ctx.say(f"resumed at epoch {start_epoch} (step {state.step}, best {fam.best_name} {best:.4f}); "
                f"training to epoch {args.epoch}", flush=True)

    t0 = time.time()
    for epoch in range(start_epoch, args.epoch):
        losses = []
        for it in range(args.train_batches):
            batch = sample(rng, rows)
            if not own_stream:
                batch = ctx.place_from_global(batch)
            losses.append(float(train_step(state, _device_batch(batch, ctx.device))["loss"]))
            if args.verbose and (it + 1) % args.verbose == 0:
                ctx.say(f"epoch {epoch + 1} iter {it + 1}/{args.train_batches} loss {losses[-1]:.4f}",
                        flush=True)
        val = _validate(kind, eval_step, model, val_batches, ctx, num_out, count)
        row = {"epoch": epoch + 1, "train_loss": float(np.mean(losses)),
               **{k: v for k, v in val.items() if k.startswith("val_")}}
        scalars.append(row)
        report = ", ".join(f"{k[4:].replace('_', ' ')} {v:.4f}" for k, v in row.items() if k.startswith("val_"))
        ctx.say(f"epoch {epoch + 1}/{args.epoch}: train loss {row['train_loss']:.4f}, val {report} "
                f"({time.time() - t0:.1f}s)", flush=True)
        generators = ctx.allgather_object(state.generator.get_state())
        saved = {"generators": generators if ctx.group is not None else None}
        if ctx.is_coordinator:
            save_checkpoint(output_dir, "model_last", state, epoch=epoch, **saved)
            # beside model_last every epoch, so a resumed run keeps its history
            (output_dir / "all_scalars.json").write_text(json.dumps(scalars, indent=2))
        if row[fam.best] > best:
            best = row[fam.best]
            if ctx.is_coordinator:
                save_checkpoint(output_dir, "model_best", state, epoch=epoch, best={fam.best: best}, **saved)
    ctx.barrier(f"train-{kind}-end")
    ctx.say(f"best {fam.best_name}: {best:.4f}", flush=True)
    return output_dir, {**(scalars[-1] if scalars else {}), "best": best}


# -------------------------------------------------------------- evaluation


def parse_eval_args(argv=None) -> argparse.Namespace:
    """The flags of the JAX package's eval_shapes.py, and --device."""
    p = argparse.ArgumentParser(description="Evaluate a shape-family run (engine/shape_runs.py).")
    p.add_argument("--folder", type=str, required=True,
                   help="run dir from train_cls_torch.py / train_partseg_torch.py")
    p.add_argument("--checkpoint", type=str, default="model_best")
    p.add_argument("--batches", type=int, default=16, help="fresh val batches")
    p.add_argument("--batch_size", type=int, default=None,
                   help="override the run's batch size (default: from config.json)")
    p.add_argument("--dump_ply", type=int, default=0,
                   help="partseg: write this many val clouds as pred + gt part-coloured PLYs")
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks to spawn on this host, one device each")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain versions)")
    p.set_defaults(dist_coordinator=None, dist_nprocs=1, dist_pid=0, dist_auto=False)
    return p.parse_args(argv)


def eval_main(argv=None):
    """The eval CLI: in this process, or on --num_devices spawned ranks."""
    args = parse_eval_args(argv)
    n = D.cli_ranks(args)
    if n == 1:
        ctx = D.cli_context(args)
        return evaluate(args, ctx)
    D.spawn_cli(evaluate, args, n)
    return None


def evaluate(args, ctx) -> dict:
    """Score a run's checkpoint on fresh batches; every model and data flag
    comes from its config.json, the kind too. Returns the metrics."""
    folder = pathlib.Path(args.folder)
    cfg_path = folder / "config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(f"{cfg_path} — is --folder a training run dir?")
    cfg = json.loads(cfg_path.read_text())
    kind = run_kind(cfg)
    if kind == "semseg":
        raise SystemExit(f"{folder} is a semantic-segmentation run: evaluate it with scripts/eval_torch.py")
    count = int(cfg["classes"] if kind == "cls" else cfg["categories"])
    batch_size = args.batch_size or int(cfg["batch_size"])
    npoints = int(cfg["npoints"])
    model = model_from_flat_config(cfg, bn_group=ctx.group)
    model.load_state_dict(load_state_dict(folder, args.checkpoint), strict=True)
    model.to(ctx.device)
    num_out = count if kind == "cls" else shapes.num_parts_total(count)
    eval_step = make_shardmap_eval_step(model, ctx.group, num_classes=num_out)
    sample = _sampler(kind, count, npoints)
    rng = np.random.default_rng(int(cfg["seed"]) + 20_000)
    ctx.say(f"evaluating {kind} run {folder.name} [{args.checkpoint}] — {args.batches} fresh batches of "
            f"{batch_size} x {npoints}" + (f", {ctx.num_processes} ranks" if ctx.num_processes > 1 else ""))
    names = cfg["shape_classes"]
    if kind == "cls":
        batches = [sample(rng, batch_size, False) for _ in range(args.batches)]
        val = _validate(kind, eval_step, model, batches, ctx, num_out, count)
        cm = val["confusion"]
        ctx.say(f"\noverall accuracy: {val['val_acc']:.4f}  ({int(np.trace(cm))}/{int(cm.sum())})")
        ctx.say(f"{'class':<14}{'acc':>8}{'count':>8}")
        per_class = {}
        for i, name in enumerate(names):
            n = int(cm[i].sum())
            per_class[name] = cm[i, i] / max(n, 1)
            ctx.say(f"{name:<14}{per_class[name]:>8.4f}{n:>8d}")
        return {"kind": kind, "accuracy": val["val_acc"], "per_class": per_class}

    cm = np.zeros((num_out, num_out), np.int64)
    per_cat: dict[int, list[float]] = {}
    dumped = 0
    preds_dir = folder / "preds"
    palette = np.asarray(PALETTE, np.uint8)
    for _ in range(args.batches):
        batch = sample(rng, batch_size, False)
        out = eval_step(model, _device_batch(ctx.place_from_global(batch), ctx.device))
        cm += out["confusion"].cpu().numpy()
        preds = ctx.all_rows(out["preds"].cpu().numpy())
        _, cat_d = instance_part_miou(preds, batch["labels"], batch["category"],
                                      shapes.part_offsets(count), shapes.part_sizes(count))
        for c, v in cat_d.items():
            per_cat.setdefault(c, []).extend(v)
        # the first --dump_ply clouds of the stream, across batches
        take = min(max(args.dump_ply - dumped, 0), batch_size)
        if take and ctx.is_coordinator:
            from pointnet2_scannet_tpu_torch.utils.ply import write_ply_points

            preds_dir.mkdir(exist_ok=True)
            for i in range(take):
                cat = names[int(batch["category"][i])]
                for tag, ids in (("pred", preds[i]), ("gt", batch["labels"][i])):
                    write_ply_points(preds_dir / f"shape{dumped + i:03d}_{cat}_{tag}.ply",
                                     batch["points"][i, :, :3], palette[ids % len(palette)])
        dumped += take
    m = confusion_to_point_metrics(cm)
    all_ious = [x for v in per_cat.values() for x in v]
    ins_miou = float(np.mean(all_ious)) if all_ious else 0.0
    cat_means = {c: float(np.mean(v)) for c, v in per_cat.items()}
    cat_miou = float(np.mean(list(cat_means.values()))) if cat_means else 0.0
    ctx.say(f"\npoint acc: {m['point_acc']:.4f}   part mIoU (confusion): {m['point_miou']:.4f}\n"
            f"instance-avg mIoU: {ins_miou:.4f}   category-avg mIoU: {cat_miou:.4f}")
    ctx.say(f"{'category':<14}{'mIoU':>8}{'shapes':>8}  parts")
    for c in sorted(cat_means):
        ctx.say(f"{names[c]:<14}{cat_means[c]:>8.4f}{len(per_cat[c]):>8d}  "
                f"{', '.join(shapes.SHAPE_PARTS[names[c]])}")
    if args.dump_ply:
        ctx.say(f"wrote {2 * dumped} PLYs to {preds_dir}")
    return {"kind": kind, "point_acc": m["point_acc"], "part_miou": m["point_miou"],
            "instance_miou": ins_miou, "category_miou": cat_miou,
            "per_category": {names[c]: v for c, v in cat_means.items()}}
