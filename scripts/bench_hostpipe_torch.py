"""The host pipeline of chunked training at ScanNet's scale, for the PyTorch
+ CUDA port: the counterpart of probes 1, 3 and 4 of scripts/bench_hostpipe.py.
One JSON line a probe, each with the card's name and power limit
(nvidia-smi's; "cpu" and null with --device cpu):

  1. store load: --scenes scenes of --points points written as .npy files
     (bench_torch.fast_scene, cached under --store), then
     SceneStore.from_npy_dir's wall and the RSS it added;
  3. one cold chunk regeneration over every scene, and one host BatchLoader
     epoch (assembly, augmentation, collation; no device);
  4. unless --host_only: the chunked SSG Solver for --epochs epochs (no
     validation), on the host path or with --device_store: each epoch's wall,
     its wait for its chunks at its start (the join of the background
     regeneration), each regeneration's wall, the ITER fetch, the store's
     flatten and upload, and points/s over the epochs after the first.

Probe 2 (sharded loading across processes) waits for ROADMAP item 12.

  python scripts/bench_hostpipe_torch.py --device_store          # the card
  python scripts/bench_hostpipe_torch.py --host_only
  python scripts/bench_hostpipe_torch.py --device cpu --scenes 8 --points 4000 \\
      --npoints 256 --batch_size 4                              # the flow, small
"""

from __future__ import annotations

import argparse
import json
import pathlib
import resource
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (the scene generator and the timed Solver run)


def rss_gb() -> float:
    """Peak resident set of this process, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def materialize(store_dir: pathlib.Path, n_scenes: int, n_points: int) -> tuple[list[str], float | None]:
    """The scene ids, their .npy files written where missing, and the wall of
    writing them (None when every file was there)."""
    import numpy as np

    store_dir.mkdir(parents=True, exist_ok=True)
    ids = [f"hp{i:04d}_00" for i in range(n_scenes)]
    missing = [i for i, sid in enumerate(ids) if not (store_dir / f"{sid}.npy").exists()]
    if not missing:
        return ids, None
    t0 = time.perf_counter()
    for i in missing:
        np.save(store_dir / f"{ids[i]}.npy", bench_torch.fast_scene(i, n_points))
    return ids, time.perf_counter() - t0


def run(args, store_dir: pathlib.Path) -> None:
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.data.pipeline import BatchLoader
    from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
        name, limit = (part.strip() for part in bench_torch.card_line().rsplit(",", 1))
    else:
        name, limit = "cpu", None

    def emit(metric: str, value: float, unit: str, **extra) -> None:
        print(json.dumps({"metric": metric, "value": value, "unit": unit, **extra, "device": name,
                          "power_limit": limit}), flush=True)

    ids, gen_s = materialize(store_dir, args.scenes, args.points)
    if gen_s is not None:
        emit("hostpipe_scene_gen_wall", gen_s, "sec", scenes=args.scenes, points=args.points)

    # 1. the store, as a run loads it (every scene in RAM)
    rss0 = rss_gb()
    t0 = time.perf_counter()
    store = SceneStore.from_npy_dir(ids, store_dir)
    emit("hostpipe_store_load_wall", time.perf_counter() - t0, "sec", scenes=len(ids),
         rss_gb=rss_gb() - rss0)

    # 3. the host's per-epoch work
    cfg = DataConfig(npoints=args.npoints, use_color=True, use_normal=True)
    ds = ChunkedSceneDataset(store, cfg, phase="train", seed=0)
    t0 = time.perf_counter()
    ds.generate_chunks()
    regen = time.perf_counter() - t0
    emit("hostpipe_chunk_regen_wall", regen, "sec", scenes=len(ids), per_scene_ms=regen / len(ids) * 1e3)
    loader = BatchLoader(ds, min(args.batch_size, len(ids)), seed=0, drop_last=True)
    t0 = time.perf_counter()
    items = sum(len(batch["points"]) for batch in loader)
    wall = time.perf_counter() - t0
    emit("hostpipe_collate_epoch_wall", wall, "sec", items_per_sec=items / wall, steps=len(loader),
         batch_ms=wall / len(loader) * 1e3)
    del ds, loader
    if args.host_only:
        emit("hostpipe_peak_rss", rss_gb(), "GB")
        return

    # 4. the Solver: does the background regeneration hide behind the steps?
    solver = bench_torch.solver_run(args.device, store, args.batch_size, args.npoints, args.epochs,
                                    args.device_store)
    extra = {"flatten_s": solver["flatten_s"], "upload_s": solver["upload_s"]} if args.device_store else {}
    emit("hostpipe_train_points_per_sec", solver["points"] / statistics.median(solver["epoch_s"][1:]),
         "points/sec", device_store=args.device_store, steps_per_epoch=len(ids) // args.batch_size,
         epoch_walls=solver["epoch_s"], regen_join_wait_s=solver["regen_join_s"],
         regen_background_wall_s=solver["regen_s"][1:], fetch_ms=[f * 1e3 for f in solver["fetch_s"]],
         losses=solver["losses"], peak_rss_gb=rss_gb(), **extra)
    if not np.isfinite(solver["losses"]).all():
        raise RuntimeError(f"non-finite losses {solver['losses']}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenes", type=int, default=1201)
    p.add_argument("--points", type=int, default=100_000)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--npoints", type=int, default=8192)
    p.add_argument("--store", type=str, default=None,
                   help="directory of the scene files, kept for reruns (default: a temporary one)")
    p.add_argument("--host_only", action="store_true", help="probes 1 and 3 only")
    p.add_argument("--device_store", action="store_true",
                   help="the Solver probe trains from the device-resident scene store")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.store is not None:
        run(args, pathlib.Path(args.store))
        return
    with tempfile.TemporaryDirectory(prefix="hostpipe_scenes_") as tmp:
        run(args, pathlib.Path(tmp))


if __name__ == "__main__":
    main()
