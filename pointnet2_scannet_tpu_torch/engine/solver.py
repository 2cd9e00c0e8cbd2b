"""Training engine: the single-device Solver of the JAX package's
engine/solver.py on one device.

Per epoch: regenerate the chunks (the next epoch's on a background thread),
train over fixed-shape batches streamed to the device by
data/pipeline.prefetch_to_device, validate with point metrics from the
device confusion matrices and voxel metrics on the host, keep model_best on
the best val voxel mIoU and model_last every epoch, and report with the same
ITER / EPOCH / BEST lines. A run dir holds config.json, best.txt,
tensorboard/all_scalars.json and the checkpoints of engine/checkpoint.py.

WholeSceneSolver trains on whole scenes instead: one optimizer update per
scene, with the gradients accumulated over fixed-size micro-batches of the
scene's columns, the last one padded and masked.

With a trace_dir, one train epoch (the second when there is one: the first
carries the allocator's and cuBLAS's warm-up) runs under torch.profiler,
host activity and, on a GPU, the card's kernels, and is written into
trace_dir as a Chrome / TensorBoard trace file (JAX: jax.profiler.trace).

With config.train.device_store the Solver trains from the device-resident
scene store (data/resident.py): the train scenes are flattened and uploaded
to the device once, each epoch's chunks are kept as store rows, a step sends
the device only those rows and the augmentation parameters, and
resident_train_step gathers its batch there. Where the store cannot serve
(a dataset without a resident mode, as whole-scene training's; a store over
the budget of _device_store_budget) it prints a WARNING and trains on the
host path, with the same math.

With a process_ctx of several ranks (parallel/distributed.py) the Solver
trains data-parallel, one rank a device (the JAX package's multi-process
Solver, solver.py:104-150): the datasets are this rank's scene shard and
the loaders assemble its batch_size / ranks rows of each global batch; the
steps of parallel/step.py sum the BatchNorm statistics, the gradients, the
loss and the confusion over the ranks; validation sums its voxel metrics
over the ranks; only the coordinator writes the run dir (config.json,
checkpoints, logs, best.txt) and prints; a resume restores every rank from
the coordinator's run dir. The whole-scene Solver does not shard scenes:
every rank walks the same scenes and takes its rows of each micro-batch.
With the device store each rank flattens and uploads its own scene shard's
rows and its ResidentBatchLoader names only those, so the store's capacity
grows with the ranks (the JAX package's row-sharded store) and each step
gathers locally, with no exchange; the budget rule applies to the largest
rank's store, decided alike on every rank.

With a process_ctx laid out on a dp x tp grid (parallel/mesh.grid_context,
train_torch.py --tp) the Solver trains tensor-parallel, the JAX Solver's
"gspmd_dp_tp" strategy (solver.py:254-278): the model is built with
bn_group=<dp group> and tp_group=<tp group>, the train state is laid out by
parallel/mesh.shard_train_state (each rank holds its slices of the split
leaves, the Adam moments with them), the data, batch and metrics follow the
dp ranks (the tp ranks of a dp index take the same rows), and the steps of
parallel/step.make_sharded_* train and validate. Checkpoints hold the whole
state, gathered over the tp ranks, in the format a tp-1 run writes; a resume
slices it onto the grid, whatever --tp wrote it. As in the JAX Solver,
--device_store under a 2-D grid falls back to the host path with a WARNING
(resident steps are single-device or data-parallel only).

With config.train.fused_steps K > 1 the chunked Solver trains K batches a
call of parallel/step.make_fused_train_step (or its resident form; the JAX
package's _run_train_epoch_fused): one CUDA graph launch a group on a card
with no group or an NCCL group, K eager steps on the CPU and under gloo,
the same math as K single steps; the epoch's leftover (len % K) batches
take one step each. The ITER line's fetch is a group's wait / K and its
step one settled launch / K, timed once a report window; the stats stay on
the device until a report. Whole-scene training is not fused (the JAX
Solver's `fusable`).
"""

from __future__ import annotations

import os
import pathlib
import time

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import RunConfig
from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
from pointnet2_scannet_tpu_torch.data.pipeline import (
    BatchLoader,
    HostGroup,
    prefetch_groups,
    prefetch_to_device,
    to_device,
)
from pointnet2_scannet_tpu_torch.data.resident import ResidentBatchLoader, flatten_store, store_nbytes
from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset
from pointnet2_scannet_tpu_torch.engine import metrics as M
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from pointnet2_scannet_tpu_torch.engine.logging import ScalarLogger
from pointnet2_scannet_tpu_torch.parallel.distributed import ProcessContext, dropout_seed
from pointnet2_scannet_tpu_torch.parallel.mesh import gather_train_state, shard_train_state
from pointnet2_scannet_tpu_torch.parallel.step import (
    make_fused_train_step,
    make_resident_fused_train_step,
    make_sharded_accum_step,
    make_sharded_eval_step,
    make_sharded_train_step,
)
from pointnet2_scannet_tpu_torch.utils.eta import decode_eta

ITER_REPORT = (
    "epoch [{epoch}/{epochs}] iter [{iter}/{iters}] "
    "loss {loss:.5f} point_acc {point_acc:.4f} point_miou {point_miou:.4f} "
    "fetch {fetch:.3f}s step {step:.3f}s eta {eta_h}h {eta_m}m {eta_s}s"
)
EPOCH_REPORT = (
    "epoch [{epoch}/{epochs}] done: train loss {train_loss:.5f} "
    "val loss {val_loss:.5f} val point_miou {val_point_miou:.4f} "
    "val voxel_miou {val_voxel_miou:.4f}"
)
BEST_REPORT = "best voxel_miou {voxel_miou:.4f} at epoch {epoch}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_store_budget(device: torch.device) -> int:
    """Bytes the device-resident scene store may take: half the card's
    memory, the other half left to activations, parameters and the
    optimizer (8 GiB on a CPU device); PN2_DEVICE_STORE_BUDGET_GB overrides."""
    gb = os.environ.get("PN2_DEVICE_STORE_BUDGET_GB")
    if gb is not None:
        return int(float(gb) * 2**30)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return 8 * 2**30


def _trace(trace_dir: str | pathlib.Path, device: torch.device):
    """torch.profiler over host activity and, on a GPU, the card's; the
    trace file goes into trace_dir when the context closes."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(trace_dir)))


class _NullLogger:
    """A non-coordinator rank's logger: it writes nothing."""

    def add_scalars(self, *args) -> None:
        pass

    def close(self) -> None:
        pass


class Solver:
    """Trains a PointNet2SemSeg on chunked scenes on one device, or on each
    rank's device of a data-parallel run (process_ctx; the model built with
    bn_group=process_ctx.dp_group, and tp_group=process_ctx.tp_group on a
    dp x tp grid)."""

    def __init__(
        self,
        model: torch.nn.Module,
        train_dataset: ChunkedSceneDataset,
        val_dataset: ChunkedSceneDataset | None,
        config: RunConfig,
        output_dir: str | pathlib.Path,
        *,
        device: torch.device | str,
        trace_dir: str | pathlib.Path | None = None,
        compute_voxel_metrics: bool = True,
        process_ctx: ProcessContext | None = None,
    ):
        self.config = config
        self.trace_dir = trace_dir  # execution only: never written into the run config
        # False: validation skips the voxel metrics and model_best gates on point mIoU
        self.compute_voxel_metrics = compute_voxel_metrics
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.output_dir = pathlib.Path(output_dir)
        self.ctx = process_ctx or ProcessContext.single(self.device)
        if self.ctx.is_coordinator:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self.num_classes = config.model.num_classes

        tc = config.train
        ranks = self.ctx.dp
        if tc.batch_size % ranks:
            raise ValueError(f"global batch_size {tc.batch_size} not divisible by {ranks} ranks")
        self.local_batch_size = tc.batch_size // ranks
        group = self.ctx.dp_group
        self.parallel_strategy = ("gspmd_dp_tp" if self.ctx.tp > 1 else
                                  "process_dp" if group is not None else "single")
        # without a tp group these are the data-parallel (or single-device) steps
        self._train_step = make_sharded_train_step(model, self.ctx, num_classes=self.num_classes)
        self._eval_step = make_sharded_eval_step(model, self.ctx, num_classes=self.num_classes)
        self.device_store = self._device_store_gate(tc.device_store, train_dataset)
        self._make_loaders(train_dataset, val_dataset, tc)
        # a rank with more steps than another would wait in a collective forever
        self.ctx.assert_uniform(len(self.train_loader), "train steps per epoch")
        if self.val_loader is not None:
            self.ctx.assert_uniform(len(self.val_loader), "val steps per epoch")
        schedule = ts.make_lr_schedule(tc.lr, tc.decay_step, tc.decay_factor, len(self.train_loader))
        # the tp ranks of a dp index draw one Dropout mask over their whole rows
        self.state = ts.create_train_state(
            self.model, schedule, weight_decay=tc.weight_decay, seed=dropout_seed(tc.seed, self.ctx.dp_index)
        )
        if self.ctx.tp > 1:
            shard_train_state(self.state, self.ctx.grid)
        self.store = self._upload_store(train_dataset) if self.device_store else None
        # fused multi-step dispatch: K steps a call, the same math per step
        self.fused_steps = max(int(tc.fused_steps or 1), 1)
        self._fused_step = None
        if self.fused_steps > 1 and isinstance(self.train_loader, (BatchLoader, ResidentBatchLoader)):
            make = make_resident_fused_train_step if self.device_store else make_fused_train_step
            self._fused_step = make(model, group, num_classes=self.num_classes, log=self.ctx.say,
                                    tp_group=self.ctx.tp_group)
        self.logger = ScalarLogger(self.output_dir) if self.ctx.is_coordinator else _NullLogger()
        self.best = {"epoch": -1, "voxel_miou": -1.0}
        self._global_iter = 0
        if self.ctx.is_coordinator:
            config.save(self.output_dir / "config.json")

    def _device_store_gate(self, wanted: bool, train_dataset) -> bool:
        """Whether this run trains from the device-resident store: only
        where it was asked for and can serve; otherwise a WARNING line says
        why and the host path trains (the same math). In a data-parallel run
        each rank's store is its shard's, the budget holds the largest of
        them, and every rank reaches the same verdict (one rank on the
        resident path and another on the host path would deadlock in their
        collectives): one exchange of each rank's (bytes, budget), one
        WARNING from the coordinator."""
        if not wanted:
            return False
        if not hasattr(train_dataset, "get_item_resident"):
            reason = "the train dataset has no resident mode (chunked training only)"
        elif self.ctx.tp > 1:  # the JAX Solver's rule (solver.py:179-186)
            reason = "resident steps are single-device or shard_map_dp only (dp-only mesh with bn_axis_name set)"
        else:
            blocks = self.ctx.allgather_object((store_nbytes(train_dataset.store, self.config.data),
                                                _device_store_budget(self.device)))
            nbytes, budget = max(b[0] for b in blocks), min(b[1] for b in blocks)
            whose = "" if len(blocks) == 1 else f" on rank {[b[0] for b in blocks].index(nbytes)}"
            reason = None if nbytes <= budget else (
                f"flat store needs {nbytes / 2**30:.2f} GiB{whose} > budget {budget / 2**30:.1f} GiB "
                "(set PN2_DEVICE_STORE_BUDGET_GB to raise)"
            )
        if reason is not None:
            self.ctx.say(f"WARNING: device_store disabled: {reason}", flush=True)
            return False
        train_dataset.resident = True
        return True

    def _upload_store(self, train_dataset) -> dict:
        """The train scenes' flat store on the device, uploaded once; no host
        copy outlives the upload. store_flatten_s and store_upload_s record
        the two halves' wall times."""
        t0 = time.perf_counter()
        pts, labels = flatten_store(train_dataset.store, self.config.data)
        t1 = time.perf_counter()
        store = {
            "points": torch.from_numpy(pts).to(self.device),
            "labels": torch.from_numpy(labels).to(self.device),
            "wtable": torch.from_numpy(train_dataset.store.label_weights.astype(np.float32)).to(self.device),
        }
        del pts, labels
        _sync(self.device)
        self.store_flatten_s, self.store_upload_s = t1 - t0, time.perf_counter() - t1
        return store

    def _make_loaders(self, train_dataset, val_dataset, tc) -> None:
        """train_loader and val_loader; len(train_loader) is the optimizer
        steps of an epoch."""
        # train: drop the ragged last batch (zero rows would enter the
        # BatchNorm statistics); val: pad it and mask the pad rows out
        # a data-parallel rank assembles its batch_size / ranks rows of each batch
        B = self.local_batch_size
        self.train_loader = (
            ResidentBatchLoader(train_dataset, B, seed=tc.seed, shuffle=tc.shuffle)
            if self.device_store
            else BatchLoader(train_dataset, B, seed=tc.seed, drop_last=True, shuffle=tc.shuffle)
        )
        if len(self.train_loader) == 0:
            raise ValueError(
                f"training dataset ({len(train_dataset)} items) yields zero batches at "
                f"batch_size={B} with drop_last; reduce batch_size or add scenes"
            )
        self.val_loader = (
            BatchLoader(val_dataset, B, seed=tc.seed, pad_last=True)
            if val_dataset is not None
            else None
        )

    def _start_epoch(self, epoch: int, epochs: int) -> None:
        """Draw this epoch's chunks (and start the next epoch's on a
        background thread, overlapping this one)."""
        for ds in (self.train_dataset, self.val_dataset):
            if ds is not None:
                ds.generate_chunks()
        if epoch + 1 < epochs:
            for ds in (self.train_dataset, self.val_dataset):
                if ds is not None:
                    ds.start_regen_async()

    # ----------------------------------------------------------------- resume

    def resume(self) -> int:
        """Restore model, optimizer, step, Dropout generator and best metrics
        from this run dir's model_last (every rank from the coordinator's run
        dir, so every rank starts from the same parameters; on a dp x tp grid
        each takes its slices); returns the epoch to continue from."""
        meta = restore_checkpoint(self.output_dir, "model_last", self.state, self.ctx.dp_index, self.ctx.grid)
        if meta.get("best"):
            self.best = meta["best"]
        start_epoch = int(meta.get("epoch", -1)) + 1
        self._global_iter = start_epoch * len(self.train_loader)
        return start_epoch

    def _save(self, name: str, epoch: int) -> None:
        """Every dp rank's Dropout generator state goes to the coordinator,
        which writes the checkpoint (every rank calls this: one collective,
        and on a dp x tp grid the all-gathers of the split leaves)."""
        generators = self.ctx.allgather_object(self.state.generator.get_state())[:: self.ctx.tp]
        full = gather_train_state(self.state, self.ctx.grid) if self.ctx.tp > 1 else None
        if self.ctx.is_coordinator:
            save_checkpoint(self.output_dir, name, self.state, epoch=epoch, best=self.best,
                            generators=generators if self.ctx.group is not None else None, full=full)

    # ------------------------------------------------------------------ train

    def __call__(self, start_epoch: int = 0) -> dict:
        """Train epochs start_epoch .. config.train.epochs - 1; returns the
        best val metrics."""
        epochs, verbose = self.config.train.epochs, self.config.train.verbose
        t_start = time.time()
        for epoch in range(start_epoch, epochs):
            self._start_epoch(epoch, epochs)
            if (self.trace_dir is not None and epoch == min(start_epoch + 1, epochs - 1)
                    and self.ctx.is_coordinator):
                print(f"capturing profiler trace -> {self.trace_dir}", flush=True)
                with _trace(self.trace_dir, self.device):
                    train_stats = self._run_train_epoch(epoch, epochs, verbose, t_start)
                self.trace_dir = None
            else:
                train_stats = self._run_train_epoch(epoch, epochs, verbose, t_start)
            self.logger.add_scalars("train", train_stats, epoch)

            if self.val_loader is not None:
                val_stats = self._run_val_epoch()
                self.logger.add_scalars("val", val_stats, epoch)
                # the coordinator decides, so every rank joins the same saves
                if self.ctx.broadcast_object(val_stats["voxel_miou"] > self.best["voxel_miou"]):
                    self.best = {"epoch": epoch, **val_stats}
                    self.ctx.say(BEST_REPORT.format(voxel_miou=val_stats["voxel_miou"], epoch=epoch), flush=True)
                    self._save("model_best", epoch)
                self.ctx.say(
                    EPOCH_REPORT.format(
                        epoch=epoch + 1, epochs=epochs, train_loss=train_stats["loss"],
                        val_loss=val_stats["loss"], val_point_miou=val_stats["point_miou"],
                        val_voxel_miou=val_stats["voxel_miou"],
                    ),
                    flush=True,
                )
            # every epoch, so an interrupted run can resume
            self._save("model_last", epoch)
        if epochs <= start_epoch:  # nothing to train: model_last must still exist
            self._save("model_last", start_epoch - 1)
        if self.ctx.is_coordinator:
            (self.output_dir / "best.txt").write_text(
                "\n".join(f"{k}: {v}" for k, v in self.best.items())
            )
        self.logger.close()
        return self.best

    def _single_step(self, batch: dict) -> dict:
        """One train step on a device batch (host or resident)."""
        if self.device_store:
            return ts.resident_train_step(self.state, self.store, batch, num_classes=self.num_classes,
                                          group=self.ctx.dp_group)
        return self._train_step(self.state, batch)

    def _run_train_epoch(self, epoch, epochs, verbose, t_start):
        if self._fused_step is not None:
            return self._run_train_epoch_fused(epoch, epochs, verbose, t_start)
        losses, cms = [], []
        fetch_times, step_times = [], []
        iters = len(self.train_loader)
        last = time.time()
        batches = prefetch_to_device(iter(self.train_loader), device=self.device)
        for it, batch in enumerate(batches):
            now = time.time()
            fetch_times.append(now - last)
            timed = bool(verbose) and (it + 1) % verbose == 0
            if timed:  # one settled step per report window, not the queue
                _sync(self.device)
                t_step = time.time()
            stats = self._single_step(batch)
            losses.append(stats["loss"])
            cms.append(stats["confusion"])
            if timed:
                _sync(self.device)
                step_times.append(time.time() - t_step)
                self._report(epoch, epochs, it, iters, t_start, cms[-verbose:],
                             loss=float(torch.stack(losses[-verbose:]).mean()),
                             fetch=float(np.mean(fetch_times[-verbose:])), step=step_times[-1])
            last = time.time()
        self._global_iter += iters
        return self._epoch_stats(float(torch.stack(losses).mean()) if losses else float("nan"), cms)

    def _run_train_epoch_fused(self, epoch, epochs, verbose, t_start):
        """A train epoch of K steps a call (the JAX package's
        _run_train_epoch_fused): groups of K, then the leftover batches one
        step each. fetch: a group's host wait / K; step: one settled launch
        / K, timed once a report window; the stats are read on the host only
        at a report."""
        losses, cms, fetch_times, step_times = [], [], [], []
        iters = len(self.train_loader)
        it_done = 0
        last = time.time()
        for item in prefetch_groups(iter(self.train_loader), self.fused_steps, device=self.device):
            now = time.time()
            k = item.k if isinstance(item, HostGroup) else 1
            fetch_times.append((now - last) / k)
            # the group whose end crosses a report boundary is the one timed
            timed = bool(verbose) and (it_done + k) // verbose > it_done // verbose
            if timed:
                _sync(self.device)
                t_step = time.time()
            if k > 1:
                args = (self.store, item) if self.device_store else (item,)
                stats = self._fused_step(self.state, *args)
            else:
                stats = self._single_step(to_device(item, self.device))
            if timed:
                _sync(self.device)
                step_times.append((time.time() - t_step) / k)
            losses.append(stats["loss"].reshape(-1))
            cms.append(stats["confusion"].reshape(-1, self.num_classes, self.num_classes))
            it_done += k
            if timed:
                window = max(verbose // k, 1)
                self._report(epoch, epochs, it_done - 1, iters, t_start,
                             [torch.cat(cms[-window:])[-verbose:].sum(0)],
                             loss=float(torch.cat(losses)[-verbose:].mean()),
                             fetch=float(np.mean(fetch_times[-window:])), step=step_times[-1])
            last = time.time()
        self._global_iter += iters
        flat = torch.cat(losses) if losses else None
        return self._epoch_stats(float(flat.mean()) if flat is not None else float("nan"),
                                 [torch.cat(cms).sum(0)] if cms else [])

    def _report(self, epoch, epochs, it, iters, t_start, cms, *, loss, fetch, step) -> None:
        """An ITER line over the report window: its mean loss, the point
        metrics of its confusion matrices (cms), the fetch and step times."""
        pm = M.confusion_to_point_metrics(torch.stack(cms).sum(0).cpu().numpy())
        iters_left = (epochs - epoch) * iters - (it + 1)
        mean_iter = (time.time() - t_start) / max(self._global_iter + it + 1, 1)
        eta = decode_eta(mean_iter * iters_left)
        self.ctx.say(
            ITER_REPORT.format(
                epoch=epoch + 1, epochs=epochs, iter=it + 1, iters=iters, loss=loss,
                point_acc=pm["point_acc"], point_miou=pm["point_miou"], fetch=fetch, step=step,
                eta_h=eta["h"], eta_m=eta["m"], eta_s=eta["s"],
            ),
            flush=True,
        )

    def _epoch_stats(self, loss: float, cms: list) -> dict:
        """An epoch's train stats: its loss and the point metrics of its
        confusion matrices."""
        cm_total = (
            torch.stack(cms).sum(0).cpu().numpy() if cms
            else np.zeros((self.num_classes, self.num_classes))
        )
        return {"loss": loss, **M.confusion_to_point_metrics(cm_total)}

    # -------------------------------------------------------------------- val

    def _run_val_epoch(self):
        losses, cms, voxel = [], [], []
        batches = prefetch_to_device(iter(self.val_loader), device=self.device, keep_host=True)
        for host, batch in batches:
            out = self._eval_step(self.model, batch)
            losses.append(out["loss"])
            cms.append(out["confusion"])
            if self.compute_voxel_metrics:
                voxel.append(self._voxel_metrics(*_real_rows(host, self.ctx.local_rows(out["preds"]))))
        if not cms:
            raise RuntimeError("validation produced no batches; check batch_size vs dataset size")
        return self._val_stats(losses, cms, voxel)

    def _voxel_metrics(self, coords, preds, targets, weights) -> tuple[float, float, float]:
        """(voxel acc, calibrated voxel acc, voxel mIoU) of one set of points."""
        (_, _, voxacc, _, cali, _), (_, voxmiou, miou_mask) = M.compute_scene_metrics(
            coords, preds, targets, weights, self.num_classes
        )
        return voxacc, cali, np.sum(voxmiou * miou_mask) / max(np.sum(miou_mask), 1)

    def _val_stats(self, losses: list, cms: list, voxel: list, *, local_voxel: bool = True) -> dict:
        """Validation stats: the mean loss, the point metrics of the summed
        confusion matrices (both already the global batches'), and the
        voxel metrics averaged over their sets, summed over the ranks where
        each rank holds its own sets (local_voxel); with no voxel sets
        (compute_voxel_metrics=False), voxel_miou is the point mIoU, which
        model_best then gates on."""
        stats = {"loss": float(torch.stack(losses).mean())}
        stats.update(M.confusion_to_point_metrics(torch.stack(cms).sum(0).cpu().numpy()))
        # each column summed as np.mean sums it (pairwise), so one rank averages as np.mean
        sums = np.array([*(np.sum(col) for col in zip(*voxel)), len(voxel)] if voxel else np.zeros(4),
                        np.float64)
        if local_voxel:
            sums = self.ctx.sum_across_processes(sums)
        if sums[3] == 0:
            stats["voxel_miou"] = stats["point_miou"]
            return stats
        stats["voxel_acc"] = float(sums[0] / sums[3])
        stats["voxel_acc_calibrated"] = float(sums[1] / sums[3])
        stats["voxel_miou"] = float(sums[2] / sums[3])
        return stats


def _real_rows(host: dict, preds: np.ndarray):
    """(coords (n, 3), preds, targets, weights) of a batch's real rows' points."""
    real = host["row_mask"] > 0
    return (host["points"][real][..., :3].reshape(-1, 3), preds[real].reshape(-1),
            host["labels"][real].reshape(-1), host["weights"][real].reshape(-1))


class _SceneBatchIterator:
    """A whole-scene dataset's scenes, each as fixed-shape micro-batches of
    its column stack: the stack is padded with zero rows to a multiple of
    batch_size and "row_mask" marks the real rows (the JAX package's
    _SceneBatchIterator)."""

    def __init__(self, dataset: WholeSceneDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return len(self.dataset)

    def scenes(self):
        """(scene id, micro-batch generator) per scene; a scene is tiled when
        its pair is drawn."""
        for i in range(len(self.dataset)):
            feats, labels, weights = self.dataset.get_scene(i)
            yield self.dataset.store.scene_ids[i], self.micro_batches(feats, labels, weights)

    def micro_batches(self, feats, labels, weights):
        B = self.batch_size
        for start in range(0, feats.shape[0], B):
            arrays = [a[start : start + B] for a in (feats, labels, weights)]
            real = arrays[0].shape[0]
            if real < B:
                arrays = [np.concatenate([a, np.zeros((B - real,) + a.shape[1:], a.dtype)])
                          for a in arrays]
            row_mask = np.zeros(B, np.float32)
            row_mask[:real] = 1.0
            yield dict(zip(("points", "labels", "weights"), arrays), row_mask=row_mask)


class WholeSceneSolver(Solver):
    """Whole-scene training (the reference's --use_wholescene, the JAX
    package's WholeSceneSolver): ONE optimizer update per scene. Each
    scene's column stack goes through fixed-size micro-batches whose
    sum-gradients accumulate (engine/train_state.grad_accum_step), then one
    Adam step applies them over the scene's point count
    (apply_accumulated); the learning-rate schedule counts scenes. Every
    epoch redraws the training columns' resampling (set_epoch(epoch + 1));
    validation keeps epoch 0's tiling and computes each scene's voxel
    metrics over the whole scene. train_dataset and val_dataset are
    WholeSceneDatasets; in the ITER report one iter is one scene.

    Data-parallel: every rank walks the same scenes (one update a scene is
    the recipe's semantics) and feeds its rows of each micro-batch
    (ProcessContext.place_from_global); the accumulated gradients, loss,
    count and confusion are summed over the ranks once a scene, and
    validation gathers each micro-batch's predictions, so every rank
    computes the same scene metrics. On a dp x tp grid the rows and sums
    are the dp ranks', and the model runs its channel shards: training and
    validation run tensor-parallel (the JAX 2-D mesh replicates the state
    for them, ROADMAP §3)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._accum_step, self._apply_accum = make_sharded_accum_step(
            self.model, self.ctx, num_classes=self.num_classes)

    def _make_loaders(self, train_dataset, val_dataset, tc) -> None:
        self.train_loader = _SceneBatchIterator(train_dataset, tc.batch_size)
        self.val_loader = (
            _SceneBatchIterator(val_dataset, tc.batch_size) if val_dataset is not None else None
        )

    def _start_epoch(self, epoch: int, epochs: int) -> None:
        self.train_dataset.set_epoch(epoch + 1)

    def _run_train_epoch(self, epoch, epochs, verbose, t_start):
        losses, cms, fetch_times = [], [], []
        iters = len(self.train_loader)
        last = time.time()
        for it, (_, micro_batches) in enumerate(self.train_loader.scenes()):
            t_iter = time.time()
            fetch_times.append(t_iter - last)
            loss_sum = count = cm = 0
            local = (self.ctx.place_from_global(mb) for mb in micro_batches)
            for mb in prefetch_to_device(local, device=self.device):
                out = self._accum_step(self.state, mb)
                loss_sum, count, cm = loss_sum + out["loss_sum"], count + out["count"], cm + out["confusion"]
            totals = ts.sum_over_ranks({"loss_sum": loss_sum, "count": count, "confusion": cm},
                                       self.ctx.dp_group)
            loss_sum, count, cm = totals["loss_sum"], totals["count"], totals["confusion"]
            self._apply_accum(self.state, count)
            losses.append(float(loss_sum) / max(float(count), 1.0))  # settles the scene's step
            cms.append(cm)
            if verbose and (it + 1) % verbose == 0:
                self._report(epoch, epochs, it, iters, t_start, cms[-verbose:],
                             loss=float(np.mean(losses[-verbose:])),
                             fetch=float(np.mean(fetch_times[-verbose:])), step=time.time() - t_iter)
            last = time.time()
        self._global_iter += iters
        return self._epoch_stats(float(np.mean(losses)) if losses else float("nan"), cms)

    def _run_val_epoch(self):
        losses, cms, voxel = [], [], []
        for _, micro_batches in self.val_loader.scenes():
            rows = []
            mbs = list(micro_batches)
            local = (self.ctx.place_from_global(mb) for mb in mbs)
            for host, mb in zip(mbs, prefetch_to_device(local, device=self.device)):
                out = self._eval_step(self.model, mb)
                losses.append(out["loss"])
                cms.append(out["confusion"])
                if self.compute_voxel_metrics:
                    # the scene's metrics need every rank's rows of the micro-batch
                    rows.append(_real_rows(host, self.ctx.all_rows(out["preds"].cpu().numpy())))
            if rows:
                voxel.append(self._voxel_metrics(*map(np.concatenate, zip(*rows))))
        if not cms:
            raise RuntimeError("validation produced no micro-batches")
        return self._val_stats(losses, cms, voxel, local_voxel=False)
