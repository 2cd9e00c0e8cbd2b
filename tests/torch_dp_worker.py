"""The ranks of the port's data-parallel CPU tests (tests/test_torch_parallel.py).

Each rank is a fresh process (torch.multiprocessing, spawn) joined to the
others over gloo on localhost; it imports torch and the port, never jax.
run_scenarios computes on this rank's rows of the inputs that the test
process wrote (inputs.pt), and writes what it got to rank<r>.pt: the
data-parallel train step of each model kind it names (Dropout off) and two
broken variants of the SSG step, MaskedBatchNorm over unequal real rows, one
whole-scene accumulated update, the host collectives and the evaluator's
merge, the sharded scene loading and the once-per-host kernel build with a
stub nvcc.
"""

from __future__ import annotations

import pathlib
import stat

import numpy as np
import torch
import torch.distributed as dist

from pointnet2_scannet_tpu_torch.data.scene_store import SceneStore
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.evaluator import SceneResult, merge_scene_results, pack_scene_results
from pointnet2_scannet_tpu_torch.models import layers, pointnet2
from pointnet2_scannet_tpu_torch.parallel import distributed as D

WORLD = 2
TIMEOUT_S = 120  # each spawn of ranks, killed past it


def rows(x: torch.Tensor, rank: int, world: int = WORLD) -> torch.Tensor:
    n = x.shape[0] // world
    return x[rank * n : (rank + 1) * n]


def port_model(spec: dict, state_dict: dict, dtype, bn_group=None) -> pointnet2.PointNet2SemSeg:
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**spec), bn_group=bn_group)
    model.load_state_dict(state_dict, strict=True)
    return model.to(dtype)


def step_result(state: ts.TrainState, out: dict) -> dict:
    """Loss, confusion, the gradients the optimizer applied, the BatchNorm
    running statistics and the updated parameters of one train step."""
    m = state.model
    return {
        "loss": float(out["loss"]),
        "confusion": out["confusion"].numpy(),
        "grads": {k: p.grad.detach().double().numpy() for k, p in m.named_parameters()},
        "stats": {k: b.double().numpy() for k, b in m.named_buffers() if b.is_floating_point()},
        "params": {k: p.detach().double().numpy() for k, p in m.named_parameters()},
    }


def dp_train_step(inputs: dict, kind: str, rank: int, group) -> dict:
    model = port_model(inputs[f"{kind}_spec"], inputs[f"{kind}_state"], torch.float64, group)
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=D.dropout_seed(0, rank))
    batch = {k: rows(v, rank) for k, v in inputs["batch"].items()}
    return step_result(state, ts.train_step(state, batch, num_classes=model.spec.num_classes, group=group))


def _forward_only_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks in the forward, this rank's cotangent alone in
    the backward: a plain dist.all_reduce's view of autograd."""
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    return x + (total - x.detach())


def broken_steps(inputs: dict, rank: int, group) -> dict:
    """The SSG step without its gradient all-reduce, and with a BatchNorm
    all-reduce whose backward keeps each rank's cotangent to itself."""
    out = {}
    saved_grads, saved_sum = ts.all_reduce_grads, layers.all_reduce_sum
    try:
        ts.all_reduce_grads = lambda params, group: None
        out["no_grad_allreduce"] = dp_train_step(inputs, "ssg", rank, group)
    finally:
        ts.all_reduce_grads = saved_grads
    try:
        layers.all_reduce_sum = _forward_only_sum
        out["forward_only_bn"] = dp_train_step(inputs, "ssg", rank, group)
    finally:
        layers.all_reduce_sum = saved_sum
    return out


def masked_bn(inputs: dict, rank: int, group) -> dict:
    """MaskedBatchNorm on this rank's rows of each case's batch: its rows of
    the output, the running statistics, and the summed gradients of the
    scale and bias and this rank's rows of x's, under a fixed cotangent."""
    out = {}
    for case, (x, mask, cot, params) in inputs["masked_bn"].items():
        bn = torch.nn.BatchNorm1d(x.shape[-1])
        with torch.no_grad():
            for name, value in params.items():
                getattr(bn, name).copy_(value)
        xs = rows(x, rank).clone().requires_grad_(True)
        y = layers.masked_batch_norm(xs, bn, rows(mask, rank), group=group)
        (y * rows(cot, rank)).sum().backward()
        D.all_reduce_grads([bn.weight, bn.bias], group)
        out[case] = {"y": y.detach().numpy(), "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy(),
                     "dx": xs.grad.numpy(), "dscale": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy()}
    return out


def wholescene_update(inputs: dict, rank: int, group, ctx: D.ProcessContext) -> dict:
    """One scene's accumulated update: every rank walks the same micro-batches
    and takes its rows of each (the last padded, one rank's rows all
    padding), then the sums go over the ranks once."""
    model = port_model(inputs["ssg_spec"], inputs["ssg_state"], torch.float64, group)
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=0)
    loss_sum = count = cm = 0
    for mb in inputs["micro_batches"]:
        local = {k: torch.from_numpy(v) for k, v in ctx.place_from_global(mb).items()}
        local = {k: v.double() if v.is_floating_point() else v for k, v in local.items()}
        res = ts.grad_accum_step(state, local, num_classes=model.spec.num_classes)
        loss_sum, count, cm = loss_sum + res["loss_sum"], count + res["count"], cm + res["confusion"]
    totals = ts.sum_over_ranks({"loss_sum": loss_sum, "count": count, "confusion": cm}, group)
    ts.apply_accumulated(state, totals["count"], group)
    return {"loss_sum": float(totals["loss_sum"]), "count": float(totals["count"]),
            "confusion": totals["confusion"].numpy(),
            "stats": {k: b.double().numpy() for k, b in model.named_buffers() if b.is_floating_point()},
            "params": {k: p.detach().double().numpy() for k, p in model.named_parameters()}}


def scene_results(n: int, classes: int = 5) -> list:
    """n per-scene results of random numbers (the merge's input)."""
    rng = np.random.default_rng(1)
    return [SceneResult(f"scene{i:04d}", rng.random(), rng.random(classes), rng.random(), rng.random(classes),
                        rng.random(), rng.random(classes), rng.random(classes),
                        rng.integers(0, 2, classes).astype(np.float64),
                        rng.integers(0, 2, classes).astype(np.float64)) for i in range(n)]


def host_collectives(ctx: D.ProcessContext, rank: int) -> dict:
    # float64 values that float32 would round: 1 + k * 2^-40 and counts past 2^24
    ragged = 1.0 + np.arange((rank + 1) * 3, dtype=np.float64).reshape(rank + 1, 3) * 2.0**-40 + rank
    counts = np.array([2.0**40 + 1 + rank, 2.0**25 + 3], np.float64)
    try:
        ctx.assert_uniform(10 + rank, "steps per epoch")
        uniform_error = None
    except ValueError as e:
        uniform_error = str(e)
    ctx.assert_uniform(7, "equal everywhere")
    merged = merge_scene_results(ctx, ctx.shard_list(scene_results(3), equalize=False), 5)
    return {"ragged": ctx.allgather_ragged(ragged), "empty": ctx.allgather_ragged(ragged[:rank]),
            "merged": ([r.scene_id for r in merged], pack_scene_results(merged, 5)),
            "sum": ctx.sum_across_processes(counts), "uniform_error": uniform_error,
            "all_rows": ctx.all_rows(np.full((2, 3), rank, np.int64))}


def sharded_loading(ctx: D.ProcessContext, scene_dir: str, scene_ids: list) -> dict:
    out = {}
    for equalize in (True, False):
        store = SceneStore.from_npy_dir_sharded(scene_ids, scene_dir, process_id=ctx.process_id,
                                                num_processes=ctx.num_processes, num_classes=5,
                                                equalize=equalize, ctx=ctx)
        out[equalize] = (store.scene_ids, store.label_weights)
    return out


def build_count(ctx: D.ProcessContext, tmp: pathlib.Path) -> None:
    """build_once_per_host against a stub nvcc that logs its calls and
    touches its outputs; the library is never loaded."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    stub = tmp / "nvcc"
    if ctx.is_coordinator:
        stub.write_text(f'#!/bin/sh\necho "$@" >> {tmp / "nvcc_calls.txt"}\nsleep 0.2\n'
                        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done\n')
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    ctx.barrier("stub written")
    build.BUILD_DIR = tmp / "_build"
    build._nvcc = lambda: str(stub)
    D.build_once_per_host(ctx)


def run_scenarios(rank: int, tmp: str, port: int) -> None:
    tmp = pathlib.Path(tmp)
    ctx = D.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    torch.set_num_threads(1)  # the small shapes gain nothing from the share of cores it set
    group = ctx.group
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {kind: dp_train_step(inputs, kind, rank, group) for kind in inputs["kinds"]}
    out.update(broken_steps(inputs, rank, group))
    out["masked_bn"] = masked_bn(inputs, rank, group)
    out["wholescene"] = wholescene_update(inputs, rank, group, ctx)
    out["host"] = host_collectives(ctx, rank)
    out["sharded"] = sharded_loading(ctx, str(tmp / "scenes"), inputs["scene_ids"])
    build_count(ctx, tmp)
    torch.save(out, tmp / f"rank{rank}.pt")
    D.shutdown(ctx)
