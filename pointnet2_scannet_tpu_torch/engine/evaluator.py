"""Whole-scene sliding-window evaluation on one device: the JAX package's
engine/evaluator.py.

Each scene's column stack runs through the model's eval forward in batches
of a fixed size, predictions are argmaxed on the device and come home at the
narrowest integer width, per-scene metrics are computed with coordinate
dedup, and the report masked-averages each class's metrics over the scenes
where the class occurs (the reference's scripts/eval.py table).

map_scenes streams a dataset through three stages:

  tiler thread  ->  column batcher + device queue  ->  scene_fn pool

The tiler uploads each scene once, features and local resample indices in
one packed int32 buffer, into a W-slot ring on the device. The main thread
packs (slot, column) descriptors across scene boundaries into full batches
of B, rebuilds each batch on the device with two row gathers (the gather
kernel, ops/cuda/gather_kernel.py, on the card; its plain version on the
CPU) and keeps up to queue_depth batches in flight. A pool of workers runs
scene_fn on each finished scene. On the card the uploads run on a side
stream from pinned memory, and predictions come home through pinned buffers
and CUDA events; on the CPU every copy is synchronous.

Data parallelism is across processes (scripts/eval_torch.py --num_devices,
--dist_*): each rank evaluates its own strided shard of the scenes
(unequal shards: every scene is covered) on its own card, and
merge_scene_results gathers the per-scene results, float64, in the
dataset's order. The JAX evaluator also splits each batch's rows over a
mesh of one process's devices (evaluator.py:184, :289); a rank of the port
drives one device, so that split has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import NUM_CLASSES, NYU_CLASSES
from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset
from pointnet2_scannet_tpu_torch.engine import metrics as M
from pointnet2_scannet_tpu_torch.engine.export import build_forward
from pointnet2_scannet_tpu_torch.ops.sampling import gather_rows

RING_SLOTS = (4, 64)  # clamps of the auto-sized ring
RING_BYTES = 2 * 1024**3  # device bytes the auto-sized ring may hold
SCENE_WORKERS = 3


@dataclasses.dataclass
class SceneResult:
    scene_id: str
    point_acc: float
    point_acc_per_class: np.ndarray
    voxel_acc: float
    voxel_acc_per_class: np.ndarray
    voxel_cali_acc: float
    point_miou: np.ndarray
    voxel_miou: np.ndarray
    acc_mask: np.ndarray
    miou_mask: np.ndarray


def pack_scene_results(results: list[SceneResult], num_classes: int = NUM_CLASSES) -> np.ndarray:
    """(n, 3 + 6C) float64 rows: each scene's three scalars, then its six
    per-class vectors (scene ids travel apart)."""
    C = num_classes
    rows = np.zeros((len(results), 3 + 6 * C), np.float64)
    for i, r in enumerate(results):
        rows[i, :3] = (r.point_acc, r.voxel_acc, r.voxel_cali_acc)
        rows[i, 3:] = np.concatenate([r.point_acc_per_class, r.voxel_acc_per_class, r.point_miou,
                                      r.voxel_miou, r.acc_mask, r.miou_mask])
    return rows


def unpack_scene_results(rows: np.ndarray, scene_ids: list[str] | None = None,
                         num_classes: int = NUM_CLASSES) -> list[SceneResult]:
    """Inverse of pack_scene_results."""
    out = []
    for i, row in enumerate(np.asarray(rows)):
        v = row[3:].reshape(6, num_classes)
        out.append(SceneResult(
            scene_id=scene_ids[i] if scene_ids else f"scene{i:04d}",
            point_acc=float(row[0]),
            point_acc_per_class=v[0],
            voxel_acc=float(row[1]),
            voxel_acc_per_class=v[1],
            voxel_cali_acc=float(row[2]),
            point_miou=v[2],
            voxel_miou=v[3],
            acc_mask=v[4],
            miou_mask=v[5],
        ))
    return out


def merge_scene_results(ctx, results: list[SceneResult], num_classes: int = NUM_CLASSES) -> list[SceneResult]:
    """Every rank's per-scene results, on every rank, in the order of the
    dataset that the ranks shard with strided_shard(..., equalize=False):
    rank p's i-th scene is scene p + i * ranks. ctx: a
    parallel.ProcessContext; every rank calls this (the JAX CLI's
    allgather_ragged of pack_scene_results)."""
    index = ctx.process_id + ctx.num_processes * np.arange(len(results), dtype=np.float64)
    rows = ctx.allgather_ragged(np.concatenate([index[:, None], pack_scene_results(results, num_classes)], 1))
    ids = [sid for part in ctx.allgather_object([r.scene_id for r in results]) for sid in part]
    order = np.argsort(rows[:, 0], kind="stable")
    return unpack_scene_results(rows[order, 1:], [ids[i] for i in order], num_classes)


@dataclasses.dataclass
class EvalReport:
    """Global masked averages and the per-class table."""

    point_acc: float
    point_acc_per_class: float
    voxel_acc: float
    voxel_acc_per_class: float
    voxel_cali_acc: float
    point_miou: float
    voxel_miou: float
    per_class_point_acc: np.ndarray
    per_class_voxel_acc: np.ndarray
    per_class_point_miou: np.ndarray
    per_class_voxel_miou: np.ndarray
    scenes: list[SceneResult]

    def format_table(self) -> str:
        lines = [
            f"Point accuracy: {self.point_acc:.6f}",
            f"Point accuracy per class: {self.point_acc_per_class:.6f}",
            f"Voxel accuracy: {self.voxel_acc:.6f}",
            f"Voxel accuracy per class: {self.voxel_acc_per_class:.6f}",
            f"Calibrated voxel accuracy: {self.voxel_cali_acc:.6f}",
            f"Point mIoU: {self.point_miou:.6f}",
            f"Voxel mIoU: {self.voxel_miou:.6f}",
            "",
            f"{'class':<16}{'point_acc':>12}{'voxel_acc':>12}{'point_miou':>12}{'voxel_miou':>12}",
        ]
        for i, name in enumerate(NYU_CLASSES):
            lines.append(
                f"{name:<16}{self.per_class_point_acc[i]:>12.6f}"
                f"{self.per_class_voxel_acc[i]:>12.6f}"
                f"{self.per_class_point_miou[i]:>12.6f}"
                f"{self.per_class_voxel_miou[i]:>12.6f}"
            )
        return "\n".join(lines)


class WholeSceneEvaluator:
    def __init__(
        self,
        model: torch.nn.Module,
        *,
        device: torch.device | str,
        batch_size: int = 32,
        num_classes: int = NUM_CLASSES,
        ring_slots: int | None = None,
        queue_depth: int = 2,
    ):
        """ring_slots: scenes resident in the device ring (W). Reusing a slot
        whose scene still has columns in flight forces a flush of the
        pipeline; None sizes the ring from the dataset's column estimates so
        that steady evaluation never flushes. queue_depth: batches in flight.
        The eval and visualize CLIs expose both as --eval_ring / --eval_depth."""
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.ring_slots = ring_slots
        self.queue_depth = queue_depth
        self._pred_dtype = M.pred_transfer_dtype(num_classes)
        self._fwd = build_forward(self.model, num_classes=num_classes)
        self.last_ring_slots: int | None = None
        # per scene of the last map_scenes, in dataset order: tiling and
        # packing ms on the tiler thread, forward ms (CUDA events on the card,
        # each batch's time shared over its columns), scene_fn ms
        self.last_timings: list[dict] = []

    def _pick_ring(self, dataset, n_pad: int, C: int, B: int, depth: int, idx_slot_bytes: int = 0) -> int:
        """The explicit ring size, else one that never flushes in steady
        evaluation: a scene drains about S_i + B * depth columns after it
        arrives while about (W - 1) * S_min columns arrive before its slot is
        reused, so W >= 1 + (S_max + B * depth) / S_min; the estimates are
        upper bounds, so S_min is halved. Clamped to RING_SLOTS and to
        RING_BYTES of features and index rows."""
        if self.ring_slots is not None:
            if self.ring_slots < 1:
                raise ValueError(f"ring_slots must be >= 1, got {self.ring_slots}")
            return self.ring_slots
        ests = dataset.estimate_columns()
        if not ests:
            return RING_SLOTS[0]
        s_max = max(ests)
        s_min = max(min(ests) // 2, 1)
        W = int(np.ceil(1.0 + (s_max + B * depth) / s_min)) + 1
        W = max(RING_SLOTS[0], min(W, RING_SLOTS[1]))
        per_slot = n_pad * C * 4 + idx_slot_bytes
        return max(2, min(W, int(RING_BYTES // max(per_slot, 1))))

    def predict_scene(self, feats: np.ndarray) -> np.ndarray:
        """(S, npoints, 3 + C) -> (S, npoints) int64 labels, in batches of
        batch_size, the last padded with zero columns."""
        B = self.batch_size
        preds = []
        with torch.inference_mode():
            for start in range(0, feats.shape[0], B):
                chunk = np.asarray(feats[start : start + B], np.float32)
                rows = chunk.shape[0]
                if rows < B:
                    chunk = np.concatenate([chunk, np.zeros((B - rows,) + chunk.shape[1:], np.float32)])
                p = self._fwd(torch.from_numpy(chunk).to(self.device)).cpu().numpy()
                preds.append(p[:rows])
        return np.concatenate(preds, axis=0).astype(np.int64)

    def _metrics_for(self, scene_id: str, coords, labels, weights, preds: np.ndarray) -> SceneResult:
        """coords: (S, npoints, 3) sampled column coordinates."""
        (pa, pa_pc, va, va_pc, cali, acc_mask), (pm, vm, miou_mask) = M.compute_scene_metrics(
            coords.reshape(-1, 3), preds.reshape(-1).astype(np.int64),
            labels.reshape(-1).astype(np.int64), weights.reshape(-1), self.num_classes,
        )
        return SceneResult(scene_id, pa, pa_pc, va, va_pc, cali, pm, vm, acc_mask, miou_mask)

    def eval_scene(self, scene_id: str, feats, labels, weights) -> SceneResult:
        preds = self.predict_scene(feats)
        return self._metrics_for(scene_id, feats[..., :3], labels, weights, preds)

    def evaluate(self, dataset: WholeSceneDataset, verbose: bool = True) -> EvalReport:
        """Every scene through map_scenes, then the aggregate report."""

        def progress(r: SceneResult) -> None:
            vm = float(np.sum(r.voxel_miou * r.miou_mask) / max(np.sum(r.miou_mask), 1))
            print(f"{r.scene_id}: point_acc {r.point_acc:.4f} voxel_miou {vm:.4f}")

        results = self.map_scenes(dataset, self._metrics_for, progress=progress if verbose else None)
        return self.aggregate(results)

    def map_scenes(self, dataset: WholeSceneDataset, scene_fn, progress=None) -> list:
        """scene_fn(scene_id, coords, labels, weights, preds) for every scene
        (coords (S, npoints, 3); labels, weights and int64 preds (S,
        npoints)), on a worker pool while the remaining forwards run; the
        results in dataset order. progress, if given, is called with each
        result as it settles. evaluate() passes the metrics, the visualize
        CLI a dedup and PLY write."""
        if len(dataset) == 0:
            return []
        B, depth, device = self.batch_size, self.queue_depth, self.device
        cuda = device.type == "cuda"
        n_pad = dataset.max_points()
        C = dataset.input_channels + 3
        NP = dataset.cfg.npoints
        # estimate_columns is an upper bound, so S_cap rows hold any scene's
        # index block; a multiple of 8, so near-identical datasets share shapes
        S_cap = (max(max(dataset.estimate_columns()), 1) + 7) // 8 * 8
        W = self._pick_ring(dataset, n_pad, C, B, depth, S_cap * NP * 4)
        if W * max(n_pad, S_cap) >= 2**31:  # the gathers' row indices are int32
            raise ValueError(f"a ring of {W} slots x {n_pad} points outgrows int32 row indices")
        self.last_ring_slots = W

        q: queue.Queue = queue.Queue(maxsize=4)
        done = object()
        stop = threading.Event()
        error: list[BaseException] = []

        def put(item) -> None:
            while not stop.is_set():
                with contextlib.suppress(queue.Full):
                    q.put(item, timeout=0.1)
                    return

        def tiler() -> None:
            # a stream context is per thread: the uploads take this side
            # stream and overlap the main thread's forwards
            stream = torch.cuda.Stream(device) if cuda else None
            try:
                with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                    for i in range(len(dataset)):
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        sid = dataset.store.scene_ids[i]
                        feats_all, col_idx, labels, weights = dataset.get_scene_indexed(i)
                        S = col_idx.shape[0]
                        if S > S_cap:
                            raise RuntimeError(f"scene {sid} tiled to {S} columns > S_cap {S_cap} "
                                               "from estimate_columns' upper bounds")
                        coords = feats_all[:, :3][col_idx]
                        # one upload a scene: the features' bits, then the indices
                        buf = torch.zeros(n_pad * C + S_cap * NP, dtype=torch.int32, pin_memory=cuda)
                        host = buf.numpy()
                        host[: n_pad * C].view(np.float32)[: feats_all.size] = feats_all.reshape(-1)
                        host[n_pad * C : n_pad * C + S * NP] = col_idx.reshape(-1)
                        dev = buf.to(device, non_blocking=cuda)
                        uploaded = None
                        if cuda:
                            uploaded = torch.cuda.Event()
                            uploaded.record(stream)
                        tile_ms = (time.perf_counter() - t0) * 1e3
                        put((sid, dev, uploaded, S, coords, labels, weights, tile_ms))
            except BaseException as e:  # noqa: BLE001 - raised again on the main thread
                error.append(e)
            finally:
                put(done)

        active: list[dict] = []  # scenes with columns buffered or in flight
        futures: list = []
        timings: list[dict] = []
        chunks: list[np.ndarray] = []  # (n, 2) int32 (slot, column) descriptor pieces
        assigns: list[tuple[dict, int, int, int]] = []  # (scene, s0, b0, n)
        buffered = 0
        inflight: list[tuple] = []  # (host preds, copied event, forward ms, assigns, rows)

        def forward(desc: np.ndarray, batch_assigns: list) -> None:
            """Queue one batch of up to B descriptors on the device (the tail
            padded with slot 0, column 0)."""
            rows = desc.shape[0]
            # per batch row: the ring row of its column's indices, and the
            # first feature row of its slot
            meta = torch.zeros((2, B), dtype=torch.int32, pin_memory=cuda)
            m = meta.numpy()
            m[0, :rows] = desc[:, 0] * S_cap + desc[:, 1]
            m[1, :rows] = desc[:, 0] * n_pad
            t0 = time.perf_counter()
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            meta = meta.to(device, non_blocking=cuda)
            local = gather_rows(idx_ring.view(1, W * S_cap, NP), meta[0:1])  # (1, B, NP)
            point_rows = (local.view(B, NP) + meta[1][:, None]).view(1, B * NP)
            points = gather_rows(stack.view(1, W * n_pad, C), point_rows).view(B, NP, C)
            labels = self._fwd(points)
            if cuda:
                end.record()
                host = torch.empty((B, NP), dtype=self._pred_dtype, pin_memory=True)
                host.copy_(labels, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
                inflight.append((host, copied, lambda: start.elapsed_time(end), batch_assigns, rows))
            else:
                ms = (time.perf_counter() - t0) * 1e3
                inflight.append((labels, None, lambda: ms, batch_assigns, rows))

        def drain_oldest(pool) -> None:
            host, copied, forward_ms, batch_assigns, rows = inflight.pop(0)
            if copied is not None:
                copied.synchronize()
            preds = host.numpy()[:rows]
            ms = forward_ms()
            for scene, s0, b0, ncols in batch_assigns:
                scene["preds"][s0 : s0 + ncols] = preds[b0 : b0 + ncols]
                scene["times"]["forward_ms"] += ms * ncols / rows
                scene["remaining"] -= ncols
                if scene["remaining"] == 0:
                    futures.append(pool.submit(timed_scene_fn, scene["times"], scene["id"], scene["coords"],
                                               scene["labels"], scene["weights"], scene["preds"]))
                    # the submitted call holds its own references: the working
                    # set stays O(active scenes), not O(dataset)
                    active.remove(scene)
                    for k in ("coords", "labels", "weights", "preds"):
                        scene[k] = None

        def timed_scene_fn(times: dict, *args):
            t0 = time.perf_counter()
            out = scene_fn(*args)
            times["metrics_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def dispatch(pool, flush: bool = False) -> None:
            nonlocal buffered, chunks, assigns
            while buffered >= B or (flush and buffered > 0):
                take, got, batch_assigns, rest, rest_assigns = [], 0, [], [], []
                for piece, (scene, s0, _, n) in zip(chunks, assigns):
                    if got == B:
                        rest.append(piece)
                        rest_assigns.append((scene, s0, 0, n))
                        continue
                    use = min(n, B - got)
                    take.append(piece[:use])
                    batch_assigns.append((scene, s0, got, use))
                    got += use
                    if use < n:
                        rest.append(piece[use:])
                        rest_assigns.append((scene, s0 + use, 0, n - use))
                chunks, assigns, buffered = rest, rest_assigns, buffered - got
                forward(np.concatenate(take, axis=0), batch_assigns)
                while len(inflight) > (0 if flush and buffered == 0 else depth):
                    drain_oldest(pool)

        printed = 0

        def report_progress(final: bool = False) -> None:
            nonlocal printed
            if progress is None:
                return
            while printed < len(futures) and (final or futures[printed].done()):
                progress(futures[printed].result())
                printed += 1

        thread = threading.Thread(target=tiler, daemon=True)
        on_device = torch.cuda.device(device) if cuda else contextlib.nullcontext()
        try:
            with on_device, torch.inference_mode(), ThreadPoolExecutor(max_workers=SCENE_WORKERS) as pool:
                stack = torch.zeros((W * n_pad, C), dtype=torch.float32, device=device)
                idx_ring = torch.zeros((W * S_cap, NP), dtype=torch.int32, device=device)
                thread.start()
                seq = 0
                while True:
                    item = q.get()
                    if item is done:
                        if error:
                            raise error[0]
                        break
                    scene_id, dev, uploaded, S, coords, labels, weights, tile_ms = item
                    slot = seq % W
                    # nothing buffered or in flight may still read the scene
                    # this slot held
                    evicted = seq - W
                    if evicted >= 0 and any(sc["seq"] <= evicted for sc in active):
                        dispatch(pool, flush=True)
                        while inflight:
                            drain_oldest(pool)
                    if uploaded is not None:
                        main = torch.cuda.current_stream(device)
                        main.wait_event(uploaded)
                        dev.record_stream(main)
                    stack[slot * n_pad : (slot + 1) * n_pad].copy_(dev[: n_pad * C].view(torch.float32).view(n_pad, C))
                    idx_ring[slot * S_cap : (slot + 1) * S_cap].copy_(dev[n_pad * C :].view(S_cap, NP))
                    times = {"scene_id": scene_id, "tile_ms": tile_ms, "forward_ms": 0.0, "metrics_ms": 0.0}
                    timings.append(times)
                    scene = {"id": scene_id, "seq": seq, "coords": coords, "labels": labels, "weights": weights,
                             "preds": np.empty((S, NP), np.int64), "remaining": S, "times": times}
                    active.append(scene)
                    desc = np.empty((S, 2), np.int32)
                    desc[:, 0] = slot
                    desc[:, 1] = np.arange(S, dtype=np.int32)
                    chunks.append(desc)
                    assigns.append((scene, 0, 0, S))
                    buffered += S
                    seq += 1
                    dispatch(pool)
                    report_progress()
                dispatch(pool, flush=True)
                while inflight:
                    drain_oldest(pool)
                results = [f.result() for f in futures]
                report_progress(final=True)
        finally:
            stop.set()
            if thread.is_alive():
                thread.join()
        self.last_timings = timings
        return results

    def aggregate(self, results: list[SceneResult]) -> EvalReport:
        """Per-class metrics masked-averaged over the scenes where the class
        occurs; scalars averaged over scenes."""
        acc_masks = np.stack([r.acc_mask for r in results])
        miou_masks = np.stack([r.miou_mask for r in results])

        def masked_mean(per_scene, masks):
            return np.sum(per_scene * masks, axis=0) / np.maximum(np.sum(masks, axis=0), 1e-8)

        pc_pa = masked_mean(np.stack([r.point_acc_per_class for r in results]), acc_masks)
        pc_va = masked_mean(np.stack([r.voxel_acc_per_class for r in results]), acc_masks)
        pc_pm = masked_mean(np.stack([r.point_miou for r in results]), miou_masks)
        pc_vm = masked_mean(np.stack([r.voxel_miou for r in results]), miou_masks)
        seen_any = acc_masks.sum(axis=0) > 0
        seen_any_miou = miou_masks.sum(axis=0) > 0
        return EvalReport(
            point_acc=float(np.mean([r.point_acc for r in results])),
            point_acc_per_class=float(pc_pa[seen_any].mean()),
            voxel_acc=float(np.mean([r.voxel_acc for r in results])),
            voxel_acc_per_class=float(pc_va[seen_any].mean()),
            voxel_cali_acc=float(np.mean([r.voxel_cali_acc for r in results])),
            point_miou=float(pc_pm[seen_any_miou].mean()),
            voxel_miou=float(pc_vm[seen_any_miou].mean()),
            per_class_point_acc=pc_pa,
            per_class_voxel_acc=pc_va,
            per_class_point_miou=pc_pm,
            per_class_voxel_miou=pc_vm,
            scenes=results,
        )
