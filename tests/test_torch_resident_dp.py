"""The device-resident scene store under data parallelism, on two gloo CPU
ranks: each rank flattens and uploads its own scene shard and its loader
names only those rows, so the step gathers locally.

One spawn of two ranks for the module (run_ranks below, joined under its
own timeout and killed past it) trains the same small SSG Solver runs on
each rank and writes what it got; the tests read it:

- the resident Solver prints no WARNING, and each rank's store equals
  data/resident.flatten_store of its own shard;
- its per-step losses and its parameters equal the data-parallel host
  path's bit for bit (augmentation off: with it on the two paths agree only
  to float32 rounding, as on one process; Dropout on);
- with PN2_DEVICE_STORE_BUDGET_GB between the two shards' sizes, so that
  only rank 1's overflows, both ranks train on the host path and one
  WARNING (the coordinator's) names rank 1's store;
- fused (K = 2, eager under gloo) + resident + data-parallel equals the
  unfused resident run.
"""

import contextlib
import io
import os
import pathlib

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch import config
from pointnet2_scannet_tpu_torch.data import chunks, resident
from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore
from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.solver import Solver
from pointnet2_scannet_tpu_torch.models import pointnet2
from pointnet2_scannet_tpu_torch.parallel import distributed as D

WORLD, TIMEOUT_S = 2, 120
# tests/test_torch_port_model.py's SMALL SSG spec at 9 channels (not imported:
# that module imports jax, which the ranks need not load)
SPEC = dict(num_classes=20, input_channels=6, npoints=(64, 16), radii=((0.3,), (0.6,)), nsamples=((8,), (8,)),
            sa_mlps=(((8, 8, 16),), ((16, 16, 32),)), fp_mlps=((16, 16), (32, 16)), cls_fc=(16,), dropout=0.5)
DATA = dict(npoints=256, use_color=True, use_normal=True, augment=False)
# 8 scenes: rank 0's shard (the even ids) small, rank 1's large
SIZES = (1500, 4500) * 4
# between the shards' store sizes (bytes = rows x 40): only rank 1's overflows
BUDGET_GB = 5e-4
CASES = ("host", "resident", "fused", "budget")


def _store() -> SceneStore:
    return SceneStore.from_scenes({f"scene{i:04d}_00": make_synthetic_scene(i, n_points=n)
                                   for i, n in enumerate(SIZES)})


def _run(case: str, ctx, tmp: pathlib.Path) -> dict:
    """One epoch of 2 steps a rank (4 scenes a shard, 2 rows a rank of the
    global batch of 4); returns what the tests read."""
    shard = _store().shard(ctx.process_id, ctx.num_processes)
    cfg = config.RunConfig(tag=case, data=config.DataConfig(**DATA), train=config.TrainConfig(
        batch_size=4, epochs=1, verbose=0, seed=0, device_store=case != "host",
        fused_steps=2 if case == "fused" else 1))
    ds = chunks.ChunkedSceneDataset(shard, cfg.data, phase="train", seed=0)
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**SPEC), bn_group=ctx.group,
                                      generator=torch.Generator().manual_seed(0))
    losses, step = [], ts.train_step

    def recorded(state, batch, **kw):  # resident_train_step and the fused steps call it too
        out = step(state, batch, **kw)
        losses.append(float(out["loss"]))
        return out

    out = io.StringIO()
    ts.train_step = recorded
    try:
        with contextlib.redirect_stdout(out):
            solver = Solver(model, ds, None, cfg, tmp / case, device="cpu", process_ctx=ctx)
            solver()
    finally:
        ts.train_step = step
    got = {"stdout": out.getvalue(), "device_store": solver.device_store, "losses": losses,
           "params": {k: v.clone() for k, v in model.state_dict().items()}, "steps": solver.state.step,
           "fused": solver._fused_step is not None}
    if solver.device_store:
        pts, labels = resident.flatten_store(shard, cfg.data)
        got["store_equal"] = (np.array_equal(solver.store["points"].numpy(), pts)
                              and np.array_equal(solver.store["labels"].numpy(), labels))
        got["store_rows"] = solver.store["points"].shape[0]
    return got


def run_ranks(rank: int, tmp: str, port: int) -> None:
    tmp = pathlib.Path(tmp)
    torch.set_num_threads(1)
    ctx = D.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    got = {}
    for case in CASES:
        if case == "budget":
            os.environ["PN2_DEVICE_STORE_BUDGET_GB"] = str(BUDGET_GB)
        got[case] = _run(case, ctx, tmp)
    torch.save(got, tmp / f"rank{rank}.pt")
    D.shutdown(ctx)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resident_dp")
    D.spawn(run_ranks, WORLD, (str(tmp), D.free_port()), timeout=TIMEOUT_S)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_each_rank_trains_from_its_own_shards_store_without_a_warning(ranks):
    shards = [_store().shard(r, WORLD) for r in range(WORLD)]
    for r, got in enumerate(ranks):
        run = got["resident"]
        assert run["device_store"] and run["store_equal"]
        assert run["store_rows"] == sum(len(s) for s in shards[r].scenes.values())
        assert "WARNING" not in run["stdout"]
    assert ranks[0]["resident"]["store_rows"] < ranks[1]["resident"]["store_rows"]


@pytest.mark.parametrize("case", ["resident", "fused"])
def test_resident_dp_steps_equal_the_dp_host_path_bit_for_bit(ranks, case):
    for got in ranks:
        host, run = got["host"], got[case]
        assert run["steps"] == host["steps"] == 2 and run["fused"] == (case == "fused")
        assert len(host["losses"]) == 2 and all(np.isfinite(host["losses"]))
        assert run["losses"] == host["losses"]
        for k, v in host["params"].items():
            assert torch.equal(run["params"][k], v), k
    for k, v in ranks[0]["fused"]["params"].items():  # every rank applies the same update
        assert torch.equal(ranks[1]["fused"]["params"][k], v), k


def test_a_budget_that_one_shard_overflows_sends_every_rank_to_the_host_path(ranks):
    rows = [got["resident"]["store_rows"] for got in ranks]
    assert rows[0] * 40 <= BUDGET_GB * 2**30 < rows[1] * 40
    for got in ranks:
        assert got["budget"]["device_store"] is False
        assert got["budget"]["losses"] == got["host"]["losses"]
    warnings = [line for got in ranks for line in got["budget"]["stdout"].splitlines() if "WARNING" in line]
    assert warnings == [f"WARNING: device_store disabled: flat store needs {rows[1] * 40 / 2**30:.2f} GiB on "
                        f"rank 1 > budget {BUDGET_GB:.1f} GiB (set PN2_DEVICE_STORE_BUDGET_GB to raise)"]
