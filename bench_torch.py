"""Benchmark of the PyTorch + CUDA port (pointnet2_scannet_tpu_torch): the
port's counterpart of bench.py. Prints ONE JSON line (with --scale or
--scale_only, one more a scale row).

    python bench_torch.py                 # the card, full size
    python bench_torch.py --device cpu    # the plain versions, small (a check of the flow, not a speed)
    python bench_torch.py --scale_only    # bench.py's --scale rows alone, one JSON line a row
    python bench_torch.py --scale         # the headline line, then those rows

Headline, as bench.py's: `metric` train_points_per_sec_ssg_b32_n8192, its
`value` the SSG train step's points a second at B 32 x 8192 x 9, float32
(forward, loss, backward, Adam, confusion matrix), from `step_ms`: the median
of 3 windows of 20 steps each between CUDA events, after 3 warm steps, with
`step_ms_min` / `step_ms_max`. The inputs are bench.py's
(bench.py:123-134): numpy's generator seeded 0, points uniform in [0, 1.5)
over xyz + 6 feature channels, labels uniform in [0, 20), weights 1; the
model's weights from torch.Generator().manual_seed(0). Other fields:

  msg_points_per_sec, msg_step_ms[_min|_max]   the MSG model, the same way
  step_ms_bf16[_min|_max],        the bfloat16 compute dtype (get_model(...,
  ssg_bf16_points_per_sec,        dtype=torch.bfloat16): float32 parameters,
  msg_bf16_points_per_sec,        Adam state and loss), SSG and MSG, the
  msg_bf16_step_ms[_min|_max]     same way on the same inputs
  step_ms_bf16_per_dispatch       step_ms_bf16 itself: the port runs one step
                                  a dispatch (bench.py's K-step fusion has no
                                  counterpart here)
  train_repeats, fused_steps      3; 1 (the port runs one step a dispatch)
  model_tflops_fwd                bench.py's analytic forward matmul FLOPs of
                                  the SSG model at B 32 x 8192 (TF)
  mfu_f32                         3 x those FLOPs / SSG step / the card's
                                  float32 peak outside the tensor cores (TF32
                                  is off): F32_PEAK by device name, null for a
                                  card not listed
  mfu_bf16                        3 x those FLOPs / the bfloat16 SSG step /
                                  the card's dense bfloat16 tensor-core peak
                                  (BF16_PEAK by device name, null for a card
                                  not listed)
  serve_columns_per_sec_ssg|msg   one warm Predictor.predict batch of 32
                                  columns (labels to the host included),
                                  median of 9
  wholescene_ms_ssg|msg           one synthetic scene's whole-scene update
                                  (grad_accum_step a micro-batch of 32
                                  columns, apply_accumulated), median of 10,
                                  as chip_smoke.py times it
  p3_step_ms[_min|_max]           the SSG step at 8 x 32768 (the 32768-point
                                  chunk recipe), as step_ms
  eval_scenes_per_sec             scripts/bench_eval.py's measure: 4 synthetic
  eval_sps_min, eval_sps_max      scenes of 100 000 points through
  eval_repeats                    WholeSceneEvaluator.evaluate (SSG, 8192-point
                                  columns, batch 16), wall clock with tiling
                                  and metrics, median of 3 after one
                                  evaluation of a one-scene dataset
  solver_points_per_sec_host      the chunked SSG Solver over 256 synthetic
  solver_points_per_sec_resident  scenes of 100 000 points (fast_scene), batch
                                  32 x 8192 x 9, no validation, 3 epochs of 8
                                  steps, on the host path and with
                                  device_store: an epoch's points over the
                                  median wall of epochs 2 and 3 (epoch 1 is
                                  warm-up)
  solver_epoch_s_host|resident    every epoch's wall, from its chunk draw to
                                  the next epoch's
  solver_fetch_ms_host|resident   the ITER report's fetch (one report an
                                  epoch, the mean of its steps), median of
                                  epochs 2 and 3
  solver_regen_join_s_host|resident  each epoch's wait for its chunks at its
                                  start (epoch 1 draws them; later epochs
                                  join the background regeneration)
  solver_regen_s_host|resident    each chunk regeneration's own wall
  solver_store_flatten_s,         the resident run's store, flattened on the
  solver_store_upload_s           host and uploaded once (1.0 GB)
  device, power_limit             nvidia-smi's name and power limit
  unported                        bench.py's fields not ported yet, each with
                                  its ROADMAP queue 1 item (none left)

--scale / --scale_only: bench.py's scale rows (bench.py:284-345, listed by
scale_rows()), one JSON line each with its `metric`, `value` points/s,
`step_ms[_min|_max]` (as step_ms), batch, npoints, input_channels, device
and power_limit: scale_ssg_{f32,bf16}_b{64,128};
scale_{ssg,msg}_mv131_{f32,bf16} (get_model(input_channels=131), B 32 x
8192); scale_ssg_{f32,bf16}_b16_n16384 and _b8_n32768. A row that runs out
of the card's memory prints its `error` in place of the numbers.

No vs_baseline (its divisor estimates another card) and no TPU figure.
--device cpu runs every cell at B 2 x 1024 (P3: 1 x 2048; the scene cut to
3 columns at micro-batch 2, the second padded; eval: 1 scene of 8000 points
at batch 2; the Solver cells: 8 scenes of 4000 points, batch 4 x 256, 3
epochs of 2 steps), one step a window and one timed serving batch, update
and evaluation: its rates are the host's.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
METRIC = "train_points_per_sec_ssg_b32_n8192"
TRAIN_REPEATS = 3
# per device: batch x points of the train and serving cells, P3's, steps a
# train window, warm-up calls, timed serving batches, the whole-scene cell's
# micro-batch, columns (None: the whole scene) and timed updates, the eval
# cell's scenes, points a scene, batch and timed evaluations, and the Solver
# cells' scenes, points a scene, batch, points a chunk and epochs. 256
# scenes keep ScanNet's 1201 scenes' ratio of chunk regeneration to steps
# (both scale with the scene count) at a fifth of the time
SIZES = {
    "cuda": {"batch": 32, "npoints": 8192, "p3": (8, 32768), "steps": 20, "warm": 3, "serve_repeats": 9,
             "ws_batch": 32, "ws_columns": None, "ws_repeats": 10, "eval": (4, 100_000, 16, 3),
             "solver": (256, 100_000, 32, 8192, 3)},
    "cpu": {"batch": 2, "npoints": 1024, "p3": (1, 2048), "steps": 1, "warm": 1, "serve_repeats": 1,
            "ws_batch": 2, "ws_columns": 3, "ws_repeats": 1, "eval": (1, 8_000, 2, 1),
            "solver": (8, 4_000, 4, 256, 3)},
}
# float32 FLOP/s outside the tensor cores, by torch.cuda.get_device_name
# (NVIDIA's data sheet: H100 SXM at 700 W)
F32_PEAK = {"NVIDIA H100 80GB HBM3": 67e12}
# dense bfloat16 FLOP/s of the tensor cores, sparsity off, by device name
# (NVIDIA's data sheet: H100 SXM at 700 W)
BF16_PEAK = {"NVIDIA H100 80GB HBM3": 989e12}
UNPORTED: dict[str, int] = {}  # bench.py's fields -> ROADMAP queue 1 item


def fwd_matmul_flops(spec, B: int, N: int) -> float:
    """Analytic forward matmul FLOPs (pointwise MLPs + head) of one batch
    (bench.py's fwd_matmul_flops, on either package's spec)."""
    pts = [N] + list(spec.npoints)
    f = 0.0
    cin_feats = spec.input_channels
    for lvl in range(len(spec.npoints)):
        M = spec.npoints[lvl]
        for s, widths in enumerate(spec.sa_mlps[lvl]):
            K = spec.nsamples[lvl][s]
            cin = cin_feats + (3 if spec.use_xyz else 0)
            for w in widths:
                f += 2.0 * B * M * K * cin * w
                cin = w
        cin_feats = sum(w[-1] for w in spec.sa_mlps[lvl])
    chans = list(spec.skip_channels)  # feature channels per level pre-FP
    cur = chans[-1]
    for lvl in reversed(range(len(spec.fp_mlps))):
        cin = cur + chans[lvl]
        for w in spec.fp_mlps[lvl]:
            f += 2.0 * B * pts[lvl] * cin * w
            cin = w
        cur = cin
    cin = cur
    for w in spec.cls_fc:
        f += 2.0 * B * N * cin * w
        cin = w
    f += 2.0 * B * N * cin * spec.num_classes
    return f


def timed_windows(fn, device, steps: int, repeats: int, warm: int) -> list[float]:
    """Sorted ms a call of fn over `repeats` windows of `steps` back-to-back
    calls, after `warm` calls: each window between its own pair of CUDA
    events on the card (all windows queued, one synchronise at the end), on
    the host clock around a synchronised window elsewhere."""
    import torch

    cuda = torch.device(device).type == "cuda"
    for _ in range(warm):
        fn()
    if not cuda:
        out = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / steps)
        return sorted(out)
    torch.cuda.synchronize()
    events = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) / steps for s, e in events)


def fresh_state(kind: str, device, dropout: float = 0.5, seed: int = 0, dtype=None, input_channels: int = 6,
                bn_group=None):
    """A train state over a seeded SSG or MSG model at full width (xyz +
    input_channels feature channels, 20 classes), of compute dtype dtype
    (None: float32); bn_group: a data-parallel run's process group."""
    import dataclasses

    import torch

    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec, ssg_spec

    spec = dataclasses.replace((msg_spec if kind == "msg" else ssg_spec)(20, input_channels), dropout=dropout)
    model = PointNet2SemSeg(spec, dtype=dtype, bn_group=bn_group, generator=torch.Generator().manual_seed(seed),
                            device=device)
    return ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=seed)


def train_inputs(batch: int, npoints: int, device, input_channels: int = 6) -> dict:
    """bench.py's train batch (bench.py:123-134), on device."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    pc = rng.uniform(0.0, 1.5, size=(batch, npoints, 3 + input_channels)).astype(np.float32)
    raw = {
        "points": pc,
        "labels": rng.integers(0, 20, size=(batch, npoints)).astype(np.int32),
        "weights": np.ones((batch, npoints), np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def train_ms(kind: str, device, batch: int, npoints: int, steps: int, warm: int,
             dtype=None, input_channels: int = 6) -> list[float]:
    """Sorted ms a train step over TRAIN_REPEATS windows of `steps` steps,
    in compute dtype dtype (None: float32), with input_channels feature
    channels beside xyz."""
    import torch

    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    state = fresh_state(kind, device, dtype=dtype, input_channels=input_channels)
    data = train_inputs(batch, npoints, device, input_channels)
    losses = []
    times = timed_windows(lambda: losses.append(ts.train_step(state, data, num_classes=20)["loss"]),
                          device, steps, TRAIN_REPEATS, warm)
    if not bool(torch.isfinite(losses[-1])):
        raise RuntimeError(f"{kind} train step at {batch} x {npoints}: the loss is not finite")
    return times


def serve_ms(kind: str, device, batch: int, npoints: int, repeats: int) -> list[float]:
    """Sorted ms of `repeats` Predictor.predict calls on one batch of `batch`
    columns (labels back on the host), after one warm call."""
    import numpy as np
    import torch

    from pointnet2_scannet_tpu_torch.engine.export import Predictor
    from pointnet2_scannet_tpu_torch.models import get_model

    model = get_model(20, is_msg=kind == "msg", input_channels=6, generator=torch.Generator().manual_seed(0))
    predictor = Predictor(model, batch_size=batch, npoints=npoints, channels=9, device=device)
    columns = train_inputs(batch, npoints, "cpu")["points"].numpy()
    labels = predictor.predict(columns)
    if labels.shape != (batch, npoints) or labels.min() < 0 or labels.max() >= 20:
        raise RuntimeError(f"{kind} serving: labels of shape {labels.shape} outside [0, 20)")
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        predictor.predict(columns)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def wholescene_dataset(n_scenes: int, npoints: int):
    """The training scenes of a --synthetic --use_wholescene run of n scenes,
    tiled at full width into npoints-point columns."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store

    cfg = DataConfig(npoints=npoints, use_color=True, use_normal=True)
    return WholeSceneDataset(make_synthetic_store(n_scenes, seed=0), cfg, seed=0)


def wholescene_time(kind: str, device, micro_batch: int, npoints: int, columns: int | None = None,
                    repeats: int = 10, warm: int = 3) -> dict:
    """The steady whole-scene update of one synthetic scene (its first
    `columns` columns where given) at micro-batches of micro_batch columns:
    grad_accum_step a micro-batch, then apply_accumulated, the micro-batches
    on the device beforehand; sorted ms of `repeats` updates, each timed
    alone, and the scene's real and padded rows."""
    import torch

    from pointnet2_scannet_tpu_torch.data.pipeline import to_device
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.solver import _SceneBatchIterator

    ds = wholescene_dataset(1, npoints)
    t0 = time.perf_counter()
    scene = ds.get_scene(0)
    tile_ms = (time.perf_counter() - t0) * 1e3
    scene = tuple(a[:columns] for a in scene)
    micro = [to_device(mb, device) for mb in _SceneBatchIterator(ds, micro_batch).micro_batches(*scene)]
    state = fresh_state(kind, device)

    def update():
        count = 0.0
        for mb in micro:
            count = count + ts.grad_accum_step(state, mb, num_classes=20)["count"]
        ts.apply_accumulated(state, count)

    times = timed_windows(update, device, 1, repeats, warm)
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise RuntimeError("the steady whole-scene updates left non-finite parameters")
    real = scene[0].shape[0]
    return {"times": times, "real": real, "padded": len(micro) * micro_batch - real,
            "micro_batches": len(micro), "tile_ms": tile_ms}


def eval_rates(device, n_scenes: int, n_points: int, npoints: int, batch: int, repeats: int) -> list[float]:
    """Sorted scenes/s of `repeats` WholeSceneEvaluator.evaluate calls over
    n_scenes synthetic scenes of n_points points (scripts/bench_eval.py's
    measure): the SSG model at full width with seeded random weights, batch
    columns a forward, wall clock with tiling and metrics, after one
    evaluation of a one-scene dataset."""
    import math

    import torch

    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store
    from pointnet2_scannet_tpu_torch.engine.evaluator import WholeSceneEvaluator
    from pointnet2_scannet_tpu_torch.models import get_model

    cfg = DataConfig(npoints=npoints, use_color=True, use_normal=True)
    model = get_model(20, is_msg=False, input_channels=6, generator=torch.Generator().manual_seed(0))
    ev = WholeSceneEvaluator(model, device=device, batch_size=batch)
    ev.evaluate(WholeSceneDataset(make_synthetic_store(1, n_points=n_points), cfg, seed=0), verbose=False)
    ds = WholeSceneDataset(make_synthetic_store(n_scenes, n_points=n_points), cfg, seed=0)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        report = ev.evaluate(ds, verbose=False)
        rates.append(n_scenes / (time.perf_counter() - t0))
    if len(report.scenes) != n_scenes or not math.isfinite(report.voxel_miou):
        raise RuntimeError(f"eval over {n_scenes} scenes: {len(report.scenes)} results, voxel mIoU "
                           f"{report.voxel_miou}")
    return sorted(rates)


def fast_scene(seed: int, n_points: int):
    """A synthetic scene in the (N, 11) preprocessed layout, vectorised: a
    floor plane and furniture boxes with class-correlated colours
    (scripts/bench_hostpipe.py's fast_scene; make_synthetic_scene costs
    seconds a scene at 100 000 points, and the Solver needs only the
    structure)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_floor = n_points // 3
    n_rest = n_points - n_floor
    xyz_floor = np.column_stack(
        [rng.uniform(0, 8, n_floor), rng.uniform(0, 8, n_floor), rng.normal(0, 0.01, n_floor)]
    )
    lab_floor = np.zeros(n_floor, np.float32)
    n_obj = 12
    centers = rng.uniform(0.5, 7.5, (n_obj, 3)) * [1, 1, 0.2]
    obj_of = rng.integers(0, n_obj, n_rest)
    xyz_rest = centers[obj_of] + rng.uniform(-0.5, 0.5, (n_rest, 3))
    lab_rest = ((obj_of * 7) % 18 + 2).astype(np.float32)
    xyz = np.vstack([xyz_floor, xyz_rest]).astype(np.float32)
    labels = np.concatenate([lab_floor, lab_rest])
    colors = (labels[:, None] * [53.0, 101.0, 181.0] % 256 + rng.normal(0, 8, (n_points, 3))).clip(0, 255)
    normals = np.zeros((n_points, 3), np.float32)
    normals[:, 2] = 1.0
    inst = np.concatenate([np.zeros(n_floor), obj_of + 1]).astype(np.float32)
    scene = np.column_stack([xyz, colors, normals, inst, labels]).astype(np.float32)
    return scene[rng.permutation(n_points)]


def solver_store(n_scenes: int, n_points: int):
    """A SceneStore of n_scenes fast_scene scenes, seeded by their index."""
    from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore

    return SceneStore.from_scenes({f"hp{i:04d}_00": fast_scene(i, n_points) for i in range(n_scenes)})


def solver_run(device, store, batch: int, npoints: int, epochs: int, device_store: bool) -> dict:
    """One run of the chunked Solver (SSG at full width, seeded weights, no
    validation, one ITER report an epoch) over `store`, on the host path or
    with device_store. Returns the epochs' walls (from one epoch's chunk draw
    to the next's, the last to the run's end), each epoch's wait for its
    chunks, each regeneration's wall, the ITER reports' fetch seconds, the
    epoch losses, the points of an epoch and, with device_store, the store's
    flatten and upload seconds. Raises where device_store fell back."""
    import contextlib
    import io
    import math
    import tempfile

    import torch

    from pointnet2_scannet_tpu_torch.config import DataConfig, RunConfig, TrainConfig
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.engine.solver import Solver
    from pointnet2_scannet_tpu_torch.models import get_model

    class TimedChunks(ChunkedSceneDataset):
        """Records when each epoch draws its chunks, how long it waits for
        them, and each regeneration's wall (on whichever thread runs it)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.starts, self.joins, self.regens = [], [], []

        def generate_chunks(self):
            t0 = time.perf_counter()
            self.starts.append(t0)
            super().generate_chunks()
            self.joins.append(time.perf_counter() - t0)

        def _generate(self):
            t0 = time.perf_counter()
            out = super()._generate()
            self.regens.append(time.perf_counter() - t0)
            return out

    fetches = []

    class TimedSolver(Solver):
        def _report(self, *args, fetch, **kwargs):
            fetches.append(fetch)
            super()._report(*args, fetch=fetch, **kwargs)

    steps = len(store) // batch
    cfg = RunConfig(tag="bench", data=DataConfig(npoints=npoints, use_color=True, use_normal=True),
                    train=TrainConfig(batch_size=batch, epochs=epochs, verbose=steps, seed=0,
                                      device_store=device_store))
    ds = TimedChunks(store, cfg.data, phase="train", seed=0)
    model = get_model(20, is_msg=False, input_channels=6, generator=torch.Generator().manual_seed(0))
    log = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="bench_solver_") as out, contextlib.redirect_stdout(log):
        solver = TimedSolver(model, ds, None, cfg, out, device=device)
        solver()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        end = time.perf_counter()
        losses = [v for _, v in solver.logger.scalars["train/loss"]]
    if solver.device_store != device_store or "device_store disabled" in log.getvalue():
        raise RuntimeError(f"the Solver ran with device_store {solver.device_store}: {log.getvalue()[-500:]}")
    if len(losses) != epochs or not all(map(math.isfinite, losses)) or len(fetches) != epochs:
        raise RuntimeError(f"the Solver's {epochs} epochs gave losses {losses} and {len(fetches)} reports")
    run = {"epoch_s": [b - a for a, b in zip(ds.starts, ds.starts[1:] + [end])], "regen_join_s": ds.joins,
           "regen_s": ds.regens, "fetch_s": fetches, "losses": losses, "points": steps * batch * npoints}
    if device_store:
        run.update(flatten_s=solver.store_flatten_s, upload_s=solver.store_upload_s)
    del solver
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return run


def solver_fields(device, n_scenes: int, n_points: int, batch: int, npoints: int, epochs: int) -> dict:
    """The Solver cells' fields: one run on the host path, then one with
    device_store, over the same store; epoch 1 of each is warm-up."""
    import statistics

    store = solver_store(n_scenes, n_points)
    runs = {path: solver_run(device, store, batch, npoints, epochs, path == "resident")
            for path in ("host", "resident")}
    row = {}
    for path, run in runs.items():
        row.update({
            f"solver_points_per_sec_{path}": run["points"] / statistics.median(run["epoch_s"][1:]),
            f"solver_epoch_s_{path}": run["epoch_s"],
            f"solver_fetch_ms_{path}": statistics.median(run["fetch_s"][1:]) * 1e3,
            f"solver_regen_join_s_{path}": run["regen_join_s"],
            f"solver_regen_s_{path}": run["regen_s"],
        })
    row.update(solver_store_flatten_s=runs["resident"]["flatten_s"],
               solver_store_upload_s=runs["resident"]["upload_s"],
               solver_scenes=n_scenes, solver_steps_per_epoch=n_scenes // batch)
    return row


def card_line() -> str:
    """The first card's `name, power.limit` line from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_fields(device: str) -> dict:
    """The row's device and power_limit: nvidia-smi's name and power limit
    of the card, or "cpu" and None."""
    name, limit = (part.strip() for part in card_line().rsplit(",", 1)) if device == "cuda" else ("cpu", None)
    return {"device": name, "power_limit": limit}


def _setup(device: str) -> None:
    """Import the port (TF32 off); refuse --device cuda without a card."""
    import torch

    sys.path.insert(0, str(ROOT))
    import pointnet2_scannet_tpu_torch  # noqa: F401  (switches TF32 off)

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")


def run(device: str = "cuda") -> dict:
    """Every cell on `device` ("cuda" or "cpu"); the JSON row."""
    import torch

    _setup(device)
    from pointnet2_scannet_tpu_torch.models import ssg_spec

    size = SIZES[device]
    b, n, steps, warm = size["batch"], size["npoints"], size["steps"], size["warm"]
    row = {"metric": METRIC, "unit": "points/sec", "batch": b, "npoints": n}
    train = {kind: train_ms(kind, device, b, n, steps, warm) for kind in ("ssg", "msg")}
    bf16 = {kind: train_ms(kind, device, b, n, steps, warm, torch.bfloat16) for kind in ("ssg", "msg")}
    ssg_ms = train["ssg"][TRAIN_REPEATS // 2]
    bf16_ms = bf16["ssg"][TRAIN_REPEATS // 2]
    flops = fwd_matmul_flops(ssg_spec(20, 6), b, n)
    card = card_fields(device)
    peak, bf16_peak = F32_PEAK.get(card["device"]), BF16_PEAK.get(card["device"])
    row.update({
        "value": b * n / ssg_ms * 1e3,
        "step_ms": ssg_ms, "step_ms_min": train["ssg"][0], "step_ms_max": train["ssg"][-1],
        "msg_points_per_sec": b * n / train["msg"][TRAIN_REPEATS // 2] * 1e3,
        "msg_step_ms": train["msg"][TRAIN_REPEATS // 2], "msg_step_ms_min": train["msg"][0],
        "msg_step_ms_max": train["msg"][-1],
        "train_repeats": TRAIN_REPEATS, "fused_steps": 1,
        "model_tflops_fwd": flops / 1e12,
        "mfu_f32": 3.0 * flops / (ssg_ms / 1e3) / peak if peak else None,
        "step_ms_bf16": bf16_ms, "step_ms_bf16_min": bf16["ssg"][0], "step_ms_bf16_max": bf16["ssg"][-1],
        "step_ms_bf16_per_dispatch": bf16_ms,
        "ssg_bf16_points_per_sec": b * n / bf16_ms * 1e3,
        "msg_bf16_points_per_sec": b * n / bf16["msg"][TRAIN_REPEATS // 2] * 1e3,
        "msg_bf16_step_ms": bf16["msg"][TRAIN_REPEATS // 2], "msg_bf16_step_ms_min": bf16["msg"][0],
        "msg_bf16_step_ms_max": bf16["msg"][-1],
        "mfu_bf16": 3.0 * flops / (bf16_ms / 1e3) / bf16_peak if bf16_peak else None,
    })
    for kind in ("ssg", "msg"):
        times = serve_ms(kind, device, b, n, size["serve_repeats"])
        row[f"serve_columns_per_sec_{kind}"] = b / times[len(times) // 2] * 1e3
    for kind in ("ssg", "msg"):
        ws = wholescene_time(kind, device, size["ws_batch"], n, size["ws_columns"], size["ws_repeats"], warm)
        row[f"wholescene_ms_{kind}"] = ws["times"][len(ws["times"]) // 2]
    n_scenes, n_points, eval_batch, eval_repeats = size["eval"]
    rates = eval_rates(device, n_scenes, n_points, n, eval_batch, eval_repeats)
    row.update({"eval_scenes_per_sec": rates[len(rates) // 2], "eval_sps_min": rates[0], "eval_sps_max": rates[-1],
                "eval_repeats": eval_repeats})
    p3 = train_ms("ssg", device, *size["p3"], steps, warm)
    row.update(solver_fields(device, *size["solver"]))
    row.update({"p3_step_ms": p3[TRAIN_REPEATS // 2], "p3_step_ms_min": p3[0], "p3_step_ms_max": p3[-1],
                **card, "unported": UNPORTED})
    return row


def scale_rows() -> list[tuple[str, str, int, int, int, str]]:
    """bench.py's --scale rows (bench.py:284-345), in its order: (metric,
    model kind, batch, points a column, input channels, dtype). The batch
    study, the multiview recipes (xyz + normal + 128-d ENet features = 131
    input channels: SA1 takes the pregather in float32) and the chunk-size
    study at constant points a step."""
    rows = [(f"scale_ssg_{dt}_b{bs}", "ssg", bs, 8192, 6, dt) for bs in (64, 128) for dt in ("f32", "bf16")]
    rows += [(f"scale_{kind}_mv131_{dt}", kind, 32, 8192, 131, dt)
             for kind in ("ssg", "msg") for dt in ("f32", "bf16")]
    rows += [(f"scale_ssg_{dt}_b{bs}_n{n}", "ssg", bs, n, 6, dt)
             for n, bs in ((16384, 16), (32768, 8)) for dt in ("f32", "bf16")]
    return rows


def scale(device: str = "cuda"):
    """Yield one JSON row a scale_rows() entry: `value` points/s and `step_ms`
    (the median of TRAIN_REPEATS windows, as step_ms), with the batch and
    points it ran at. On the card a row that runs out of device memory
    comes back with its error in place of the numbers. --device cpu runs
    each row at batch / 32 (at least 1) x points / 8, one step a window."""
    import torch

    _setup(device)
    size = SIZES[device]
    card = card_fields(device)
    for metric, kind, batch, npoints, channels, dt in scale_rows():
        if device == "cpu":
            batch, npoints = max(1, batch // 32), npoints // 8
        row = {"metric": metric, "unit": "points/sec", "batch": batch, "npoints": npoints,
               "input_channels": channels, **card}
        try:
            times = train_ms(kind, device, batch, npoints, size["steps"], size["warm"],
                             torch.bfloat16 if dt == "bf16" else None, channels)
        except torch.cuda.OutOfMemoryError as e:
            row["error"] = f"out of device memory: {str(e).splitlines()[0]}"
        else:
            ms = times[TRAIN_REPEATS // 2]
            row.update(value=batch * npoints / ms * 1e3, step_ms=ms, step_ms_min=times[0], step_ms_max=times[-1])
        if device == "cuda":
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--scale", action="store_true", help="bench.py's scale rows after the headline row")
    p.add_argument("--scale_only", action="store_true", help="bench.py's scale rows alone")
    args = p.parse_args(argv)
    if not args.scale_only:
        print(json.dumps(run(args.device)), flush=True)
    if args.scale or args.scale_only:
        for row in scale(args.device):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
