"""Training engine: the single-device Solver of the JAX package's
engine/solver.py on one device.

Per epoch: regenerate the chunks (the next epoch's on a background thread),
train over fixed-shape batches streamed to the device by
data/pipeline.prefetch_to_device, validate with point metrics from the
device confusion matrices and voxel metrics on the host, keep model_best on
the best val voxel mIoU and model_last every epoch, and report with the same
ITER / EPOCH / BEST lines. A run dir holds config.json, best.txt,
tensorboard/all_scalars.json and the checkpoints of engine/checkpoint.py.

The JAX package's meshes (dp, dp x tp), multi-process runs, resident scene
store and profiler capture are not ported (ROADMAP queue 1, items 12 and 13);
the whole-scene WholeSceneSolver is item 5. The train step runs once per
batch: --fused_steps K is recorded in the config and gives the same math per
step as K steps fused (CUDA graphs are item 12).
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import RunConfig
from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
from pointnet2_scannet_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from pointnet2_scannet_tpu_torch.engine import metrics as M
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from pointnet2_scannet_tpu_torch.engine.logging import ScalarLogger
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


class Solver:
    """Trains a PointNet2SemSeg on chunked scenes on one device."""

    def __init__(
        self,
        model: torch.nn.Module,
        train_dataset: ChunkedSceneDataset,
        val_dataset: ChunkedSceneDataset | None,
        config: RunConfig,
        output_dir: str | pathlib.Path,
        *,
        device: torch.device | str,
    ):
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.output_dir = pathlib.Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.num_classes = config.model.num_classes

        tc = config.train
        # train: drop the ragged last batch (zero rows would enter the
        # BatchNorm statistics); val: pad it and mask the pad rows out
        self.train_loader = BatchLoader(
            train_dataset, tc.batch_size, seed=tc.seed, drop_last=True, shuffle=tc.shuffle
        )
        if len(self.train_loader) == 0:
            raise ValueError(
                f"training dataset ({len(train_dataset)} items) yields zero batches at "
                f"batch_size={tc.batch_size} with drop_last; reduce batch_size or add scenes"
            )
        self.val_loader = (
            BatchLoader(val_dataset, tc.batch_size, seed=tc.seed, pad_last=True)
            if val_dataset is not None
            else None
        )
        schedule = ts.make_lr_schedule(tc.lr, tc.decay_step, tc.decay_factor, len(self.train_loader))
        self.state = ts.create_train_state(
            self.model, schedule, weight_decay=tc.weight_decay, seed=tc.seed
        )
        self.logger = ScalarLogger(self.output_dir)
        self.best = {"epoch": -1, "voxel_miou": -1.0}
        self._global_iter = 0
        config.save(self.output_dir / "config.json")

    # ----------------------------------------------------------------- resume

    def resume(self) -> int:
        """Restore model, optimizer, step, Dropout generator and best metrics
        from this run dir's model_last; returns the epoch to continue from."""
        meta = restore_checkpoint(self.output_dir, "model_last", self.state)
        if meta.get("best"):
            self.best = meta["best"]
        start_epoch = int(meta.get("epoch", -1)) + 1
        self._global_iter = start_epoch * len(self.train_loader)
        return start_epoch

    def _save(self, name: str, epoch: int) -> None:
        save_checkpoint(self.output_dir, name, self.state, epoch=epoch, best=self.best)

    # ------------------------------------------------------------------ train

    def __call__(self, start_epoch: int = 0) -> dict:
        """Train epochs start_epoch .. config.train.epochs - 1; returns the
        best val metrics."""
        epochs, verbose = self.config.train.epochs, self.config.train.verbose
        t_start = time.time()
        for epoch in range(start_epoch, epochs):
            for ds in (self.train_dataset, self.val_dataset):
                if ds is not None:
                    ds.generate_chunks()
            if epoch + 1 < epochs:  # overlap the next epoch's chunking with this one
                for ds in (self.train_dataset, self.val_dataset):
                    if ds is not None:
                        ds.start_regen_async()
            train_stats = self._run_train_epoch(epoch, epochs, verbose, t_start)
            self.logger.add_scalars("train", train_stats, epoch)

            if self.val_loader is not None:
                val_stats = self._run_val_epoch()
                self.logger.add_scalars("val", val_stats, epoch)
                if val_stats["voxel_miou"] > self.best["voxel_miou"]:
                    self.best = {"epoch": epoch, **val_stats}
                    print(BEST_REPORT.format(voxel_miou=val_stats["voxel_miou"], epoch=epoch), flush=True)
                    self._save("model_best", epoch)
                print(
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
        (self.output_dir / "best.txt").write_text(
            "\n".join(f"{k}: {v}" for k, v in self.best.items())
        )
        self.logger.export()
        return self.best

    def _run_train_epoch(self, epoch, epochs, verbose, t_start):
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
            stats = ts.train_step(self.state, batch, num_classes=self.num_classes)
            losses.append(stats["loss"])
            cms.append(stats["confusion"])
            if timed:
                _sync(self.device)
                step_times.append(time.time() - t_step)
                cm = torch.stack(cms[-verbose:]).sum(0).cpu().numpy()
                pm = M.confusion_to_point_metrics(cm)
                iters_left = (epochs - epoch) * iters - (it + 1)
                mean_iter = (time.time() - t_start) / max(self._global_iter + it + 1, 1)
                eta = decode_eta(mean_iter * iters_left)
                print(
                    ITER_REPORT.format(
                        epoch=epoch + 1, epochs=epochs, iter=it + 1, iters=iters,
                        loss=float(torch.stack(losses[-verbose:]).mean()),
                        point_acc=pm["point_acc"], point_miou=pm["point_miou"],
                        fetch=float(np.mean(fetch_times[-verbose:])), step=step_times[-1],
                        eta_h=eta["h"], eta_m=eta["m"], eta_s=eta["s"],
                    ),
                    flush=True,
                )
            last = time.time()
        self._global_iter += iters
        out = {"loss": float(torch.stack(losses).mean()) if losses else float("nan")}
        cm_total = (
            torch.stack(cms).sum(0).cpu().numpy() if cms
            else np.zeros((self.num_classes, self.num_classes))
        )
        out.update(M.confusion_to_point_metrics(cm_total))
        return out

    # -------------------------------------------------------------------- val

    def _run_val_epoch(self):
        losses, cms = [], []
        vox_accs, vox_mious, vox_cali = [], [], []
        batches = prefetch_to_device(iter(self.val_loader), device=self.device, keep_host=True)
        for host, batch in batches:
            out = ts.eval_step(self.model, batch, num_classes=self.num_classes)
            losses.append(out["loss"])
            cms.append(out["confusion"])
            real = host["row_mask"] > 0
            coords = host["points"][real][..., :3].reshape(-1, 3)
            preds = out["preds"].cpu().numpy()[real].reshape(-1)
            targets = host["labels"][real].reshape(-1)
            weights = host["weights"][real].reshape(-1)
            (_, _, voxacc, _, cali, _), (_, voxmiou, miou_mask) = M.compute_scene_metrics(
                coords, preds, targets, weights, self.num_classes
            )
            vox_accs.append(voxacc)
            vox_cali.append(cali)
            vox_mious.append(np.sum(voxmiou * miou_mask) / max(np.sum(miou_mask), 1))
        if not cms:
            raise RuntimeError("validation produced no batches; check batch_size vs dataset size")
        stats = {"loss": float(torch.stack(losses).mean())}
        stats.update(M.confusion_to_point_metrics(torch.stack(cms).sum(0).cpu().numpy()))
        stats["voxel_acc"] = float(np.mean(vox_accs))
        stats["voxel_acc_calibrated"] = float(np.mean(vox_cali))
        stats["voxel_miou"] = float(np.mean(vox_mious))
        return stats
