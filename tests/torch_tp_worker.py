"""The ranks of the port's tensor-parallel CPU tests (tests/test_torch_tp.py).

WORLD gloo ranks on localhost, each a fresh process (torch.multiprocessing,
spawn) that imports torch and the port, never jax. They form one 2 x 2 grid
(parallel/mesh.make_mesh_2d); the dp 1 x tp 2 grid runs on the tp groups
of that world (ranks 0-1 and 2-3, each pair on the whole batch). For each
grid and model kind, run_scenarios computes one train step from the
inputs that the test process wrote (inputs.pt), from the full weights,
on this rank's dp rows, and writes to rank<r>.pt the loss, the logits, the
confusion, the gradients the optimizer applied, the BatchNorm statistics
and the updated state, the split leaves gathered whole; the layout of the
sharded state; two broken variants of the SSG step; one whole-scene update
(MaskedBatchNorm); the eval step; the pregather composition of one MLP; and
a checkpoint round trip through tp 1.
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch
import torch.distributed as dist

from pointnet2_scannet_tpu_torch.engine import checkpoint
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.models import layers, pointnet2
from pointnet2_scannet_tpu_torch.parallel import distributed as D
from pointnet2_scannet_tpu_torch.parallel import mesh

WORLD = 4
TIMEOUT_S = 150  # the spawn of ranks, killed past it
GRIDS = ("1x2", "2x2")


def port_model(spec: dict, state_dict: dict | None = None, bn_group=None, tp_group=None):
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**spec), bn_group=bn_group, tp_group=tp_group)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(torch.float64)


def fresh_state(spec: dict, state_dict: dict, grid: mesh.Grid, bn_group=None) -> ts.TrainState:
    """A float64 train state from the full weights, laid out on grid."""
    model = port_model(spec, state_dict, grid.dp_group if bn_group is None else bn_group, grid.tp_group)
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=0)
    mesh.shard_train_state(state, grid)
    return state


def dp_rows(x: torch.Tensor, grid: mesh.Grid) -> torch.Tensor:
    n = x.shape[0] // grid.dp
    return x[grid.dp_index * n : (grid.dp_index + 1) * n]


def gathered(state: ts.TrainState, grid: mesh.Grid, tensors: dict) -> dict:
    """name -> the whole float64 tensor of each of the model's tensors."""
    return {k: (mesh.gather_leaf(t, grid) if state.shardings[k] else t.detach()).double().numpy()
            for k, t in tensors.items()}


def step_result(state: ts.TrainState, grid: mesh.Grid, batch: dict) -> dict:
    """One train step on this rank's dp rows of batch, and what it did."""
    m = state.model
    seen = {}
    hook = m.register_forward_hook(lambda mod, args, out: seen.update(logits=out.detach().clone()))
    try:
        out = ts.train_step(state, {k: dp_rows(v, grid) for k, v in batch.items()},
                            num_classes=m.spec.num_classes, group=grid.dp_group)
    finally:
        hook.remove()
    full = mesh.gather_train_state(state, grid)
    return {
        "loss": float(out["loss"]),
        "logits": seen["logits"].numpy(),
        "confusion": out["confusion"].numpy(),
        "grads": gathered(state, grid, {k: p.grad for k, p in m.named_parameters()}),
        "stats": {k: v.double().numpy() for k, v in full["model"].items() if "running_" in k},
        "params": {k: full["model"][k].double().numpy() for k, _ in m.named_parameters()},
        "adam": {k: {n: v.double().numpy() for n, v in st.items() if n != "step"}
                 for k, st in zip([n for n, _ in m.named_parameters()], full["optimizer"]["state"].values())},
    }


def layout(state: ts.TrainState) -> dict:
    """This rank's numel of every leaf, and of every Adam moment by
    parameter, after one step (the moments exist then)."""
    m, opt = state.model, state.optimizer
    return {"leaves": {k: t.numel() for k, t in [*m.named_parameters(), *m.named_buffers()]},
            "adam": {k: {n: v.numel() for n, v in opt.state[p].items()} for k, p in m.named_parameters()},
            "shardings": dict(state.shardings)}


def broken_steps(inputs: dict, grid: mesh.Grid) -> dict:
    """The SSG step with the column-parallel input's backward left without
    its tp all-reduce, and with the BatchNorm statistics summed over the tp
    group in place of the dp group."""
    out = {}
    saved = layers.column_parallel_input
    try:
        layers.column_parallel_input = lambda x, group: x
        out["no_tp_all_reduce"] = step_result(fresh_state(inputs["ssg_spec"], inputs["ssg_state"], grid), grid,
                                              inputs["batch"])["grads"]
    finally:
        layers.column_parallel_input = saved
    state = fresh_state(inputs["ssg_spec"], inputs["ssg_state"], grid, bn_group=grid.tp_group)
    out["bn_over_tp"] = step_result(state, grid, inputs["batch"])["grads"]
    return out


def wholescene_update(inputs: dict, ctx: D.ProcessContext) -> dict:
    """One scene's accumulated update on the grid of ctx: every rank walks
    the same micro-batches and takes its dp rows of each (the last padded),
    then the sums go over the dp ranks once."""
    grid = ctx.grid
    state = fresh_state(inputs["ssg_spec"], inputs["ssg_state"], grid)
    loss_sum = count = 0
    for mb in inputs["micro_batches"]:
        local = {k: torch.from_numpy(v) for k, v in ctx.place_from_global(mb).items()}
        local = {k: v.double() if v.is_floating_point() else v for k, v in local.items()}
        res = ts.grad_accum_step(state, local, num_classes=state.model.spec.num_classes)
        loss_sum, count = loss_sum + res["loss_sum"], count + res["count"]
    totals = ts.sum_over_ranks({"loss_sum": loss_sum, "count": count}, grid.dp_group)
    ts.apply_accumulated(state, totals["count"], grid.dp_group)
    full = mesh.gather_train_state(state, grid)["model"]
    return {"loss_sum": float(totals["loss_sum"]), "count": float(totals["count"]),
            "state": {k: v.double().numpy() for k, v in full.items() if v.is_floating_point()}}


def eval_result(inputs: dict, grid: mesh.Grid) -> dict:
    """The eval step after one train step: loss, confusion, this rank's preds."""
    state = fresh_state(inputs["ssg_spec"], inputs["ssg_state"], grid)
    step_result(state, grid, inputs["batch"])
    out = ts.eval_step(state.model, {k: dp_rows(v, grid) for k, v in inputs["batch"].items()},
                       num_classes=state.model.spec.num_classes, group=grid.dp_group)
    return {"loss": float(out["loss"]), "confusion": out["confusion"].numpy(), "preds": out["preds"].numpy()}


def pregather(inputs: dict, grid: mesh.Grid) -> dict:
    """One MLP's pregather composition in train mode, split over the tp
    group: its output, the BatchNorm statistics and the gradients of the
    weights (gathered) and of the features under a fixed cotangent."""
    case = inputs["pregather"]
    mlp = layers.PointwiseMLP(case["c_in"], case["widths"], tp_group=grid.tp_group)
    mlp.load_state_dict(case["state"])
    mlp = mlp.double().train()
    state = ts.TrainState(mlp, torch.optim.SGD(mlp.parameters(), lr=0.0), lambda s: 0.0, torch.Generator())
    mesh.shard_train_state(state, grid)
    feats = case["features"].clone().requires_grad_(True)
    y = mlp.pregather(case["xyz"], feats, case["idx"], case["new_xyz"])
    (y * case["cot"]).sum().backward()
    return {"y": y.detach().numpy(), "dfeatures": feats.grad.numpy(),
            "grads": gathered(state, grid, {k: p.grad for k, p in mlp.named_parameters()}),
            "stats": gathered(state, grid, {k: b for k, b in mlp.named_buffers() if "running_" in k})}


def checkpoint_round_trip(inputs: dict, ctx: D.ProcessContext, tmp: pathlib.Path) -> dict:
    """tp 2 -> file -> tp 1 -> file -> tp 2: the coordinator saves the
    gathered state of a 2 x 2 run after one step; one tp-1 process restores
    and saves it; every rank restores that onto the grid and gathers it."""
    grid = ctx.grid
    spec, sd = inputs["msg_spec"], inputs["msg_state"]
    state = fresh_state(spec, sd, grid)
    step_result(state, grid, inputs["batch"])
    full = mesh.gather_train_state(state, grid)
    if ctx.is_coordinator:
        checkpoint.save_checkpoint(tmp / "tp2", "model_last", state, epoch=0, full=full)
    ctx.barrier("tp 2 saved")
    if ctx.is_coordinator:  # a tp-1 process: the file's tensors as they are
        single = ts.create_train_state(port_model(spec), ts.make_lr_schedule(1e-3, 1, 1.0, 1), seed=0)
        checkpoint.restore_checkpoint(tmp / "tp2", "model_last", single)
        checkpoint.save_checkpoint(tmp / "tp1", "model_last", single, epoch=0)
    ctx.barrier("tp 1 saved")
    again = fresh_state(spec, sd, grid)
    checkpoint.restore_checkpoint(tmp / "tp1", "model_last", again, ctx.dp_index, grid)
    back = mesh.gather_train_state(again, grid)
    differ = [k for k, v in full["model"].items() if not torch.equal(back["model"][k], v)]
    for i, entry in full["optimizer"]["state"].items():
        differ += [f"optimizer.{i}.{n}" for n, v in entry.items()
                   if not torch.equal(back["optimizer"]["state"][i][n], v)]
    return {"differ": differ, "step": again.step, "numel": sum(p.numel() for p in again.model.parameters())}


def run_scenarios(rank: int, tmp: str, port: int) -> None:
    tmp = pathlib.Path(tmp)
    ctx = D.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    torch.set_num_threads(1)  # the small shapes gain nothing from the share of cores it set
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    grid22 = mesh.make_mesh_2d(ctx, 2, 2)
    # dp 1 x tp 2: each tp group of the 2 x 2 grid on the whole batch
    grid12 = dataclasses.replace(grid22, dp=1, dp_index=0, dp_group=None, dp_host_group=None)
    grids = {"1x2": grid12, "2x2": grid22}
    out = {"steps": {}, "layout": {}}
    for name, grid in grids.items():
        for kind in ("ssg", "msg"):
            state = fresh_state(inputs[f"{kind}_spec"], inputs[f"{kind}_state"], grid)
            out["steps"][name, kind] = step_result(state, grid, inputs["batch"])
            if name == "1x2":
                out["layout"][kind] = layout(state)
    out["broken"] = broken_steps(inputs, grid12)
    out["wholescene"] = {name: wholescene_update(inputs, dataclasses.replace(ctx, grid=grid))
                         for name, grid in grids.items()}
    out["eval"] = eval_result(inputs, grid22)
    out["pregather"] = pregather(inputs, grid12)
    out["checkpoint"] = checkpoint_round_trip(inputs, dataclasses.replace(ctx, grid=grid22), tmp)
    out["coords"] = (grid22.dp_index, grid22.tp_index, dist.get_rank(grid22.tp_group))
    torch.save(out, tmp / f"rank{rank}.pt")
    D.shutdown(ctx)
