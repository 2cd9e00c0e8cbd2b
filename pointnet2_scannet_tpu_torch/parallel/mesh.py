"""The dp x tp grid and the tensor-parallel layout of a train state: the
JAX package's parallel/mesh.py make_mesh_2d (:69), train_state_shardings
(:95) and shard_train_state (:119).

The JAX package lays a (dp, tp) mesh over one process's devices and lets
GSPMD partition the step. Here each rank is a process (parallel/
distributed.py), and the grid is a set of process groups:

- world rank r sits at dp index r // tp and tp index r % tp (the JAX
  reshape(dp, tp) of the device list);
- the dp group joins the ranks of one tp index: they hold other rows of the
  global batch and sum BatchNorm statistics, gradients, loss and confusion;
- the tp group joins the ranks of one dp index: they hold the same rows and
  split every Linear's output channels (models/layers.py).

The leaf rule is the JAX rule in PyTorch's layout: a Linear weight (out, in)
is split along dim 0 where tp divides out (JAX's P(None, tp) on the flax
kernel (in, out)); a 1-D leaf (a bias, a BatchNorm scale, bias or running
statistic, the Adam moments of those) where tp divides its size and the
size is at least tp; every other leaf stays whole on every rank (the Adam
step count, num_batches_tracked, a head whose width tp does not divide).
Shard r of a split leaf is its r-th of tp equal slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from pointnet2_scannet_tpu_torch.parallel.distributed import ProcessContext, all_gather_last


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on a dp x tp grid and the groups of its row and
    column. dp_group: device collectives over the ranks of this tp index
    (None where dp is 1); tp_group: over the ranks of this dp index (None
    where tp is 1); dp_host_group: a gloo group over the dp ranks for host
    vectors (dp_group itself under gloo)."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: Any = None
    tp_group: Any = None
    dp_host_group: Any = None


def make_mesh_2d(ctx: ProcessContext, dp: int, tp: int) -> Grid:
    """This rank's Grid over ctx's dp * tp ranks. Every rank calls it (each
    new group is made by all ranks, in one order). The device groups take
    the backend of ctx.group (NCCL on cards, gloo on the CPU or where the
    ranks were started with an explicit gloo backend)."""
    if dp * tp != ctx.num_processes:
        raise ValueError(f"a {dp} x {tp} grid needs {dp * tp} ranks, not {ctx.num_processes}")
    rank = ctx.process_id
    if ctx.group is None:  # one process
        return Grid(1, 1, 0, 0)
    backend = dist.get_backend(ctx.group)
    dp_group = dp_host_group = tp_group = None
    if dp > 1:
        for t in range(tp):
            ranks = [d * tp + t for d in range(dp)]
            group = dist.new_group(ranks, backend=backend)
            host = group if backend == "gloo" else dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                dp_group, dp_host_group = group, host
    if tp > 1:
        for d in range(dp):
            ranks = list(range(d * tp, (d + 1) * tp))
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                tp_group = group
    return Grid(dp, tp, rank // tp, rank % tp, dp_group, tp_group, dp_host_group)


def grid_context(ctx: ProcessContext, tp: int) -> ProcessContext:
    """ctx laid out on a (ranks / tp) x tp grid; tp 1 leaves it as it is
    (data parallelism alone)."""
    if tp <= 1:
        return ctx
    if ctx.num_processes % tp:
        raise ValueError(f"--tp {tp} does not divide num_devices {ctx.num_processes}")
    return dataclasses.replace(ctx, grid=make_mesh_2d(ctx, ctx.num_processes // tp, tp))


def leaf_split(shape: tuple, tp: int) -> bool:
    """The leaf rule (module docstring): whether a leaf of this full shape
    is split over tp ranks."""
    if tp <= 1:
        return False
    if len(shape) == 2:
        return shape[0] % tp == 0
    return len(shape) == 1 and shape[0] % tp == 0 and shape[0] >= tp


def train_state_shardings(model: torch.nn.Module, tp: int) -> dict[str, bool]:
    """name -> split, for every parameter and buffer of a model that holds
    its full tensors (the leaf rule). The Adam moments of a parameter follow
    it; its step count is 0-d and stays whole."""
    leaves = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return {name: leaf_split(tuple(t.shape), tp) for name, t in leaves.items()}


def _slice(t: torch.Tensor, tp: int, index: int) -> torch.Tensor:
    return t.chunk(tp, dim=0)[index].clone()


def _set_leaf(model: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    module_name, _, leaf = name.rpartition(".")
    module = model.get_submodule(module_name)
    if leaf in module._parameters:
        module._parameters[leaf].data = value
    else:
        module._buffers[leaf] = value


def shard_state_dict(state_dict: dict, shardings: dict[str, bool], grid: Grid) -> dict:
    """This rank's slices of a full model state_dict."""
    return {k: _slice(v, grid.tp, grid.tp_index) if shardings.get(k) else v for k, v in state_dict.items()}


def shard_optimizer_state(optimizer_state: dict, model: torch.nn.Module, shardings: dict[str, bool],
                          grid: Grid) -> dict:
    """This rank's slices of a full optimizer state_dict over model's
    parameters (in model.parameters() order): a split parameter's moments
    are split, every 0-d entry stays whole."""
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, entry in optimizer_state["state"].items():
        split = shardings[names[int(i)]]
        state[i] = {k: _slice(v, grid.tp, grid.tp_index) if split and torch.is_tensor(v) and v.dim() else v
                    for k, v in entry.items()}
    return {**optimizer_state, "state": state}


def shard_train_state(state, grid: Grid) -> None:
    """Lay a TrainState (engine/train_state.py) whose model holds its full
    tensors out on the grid, in place: each split leaf of the model and of
    the optimizer becomes this rank's slice; the parameters stay the same
    Parameter objects, so the optimizer keeps them. Records the layout as
    state.shardings (gather_train_state reads it). tp 1 does nothing."""
    if grid.tp <= 1:
        return
    model = state.model
    shardings = train_state_shardings(model, grid.tp)
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if shardings[name]:
                _set_leaf(model, name, _slice(t.detach(), grid.tp, grid.tp_index))
        for name, p in model.named_parameters():
            for k, v in state.optimizer.state.get(p, {}).items():
                if shardings[name] and torch.is_tensor(v) and v.dim():
                    state.optimizer.state[p][k] = _slice(v, grid.tp, grid.tp_index)
    state.shardings = shardings


def gather_leaf(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The full tensor of a split leaf from every tp rank's slice (dim 0)."""
    moved = t.detach().movedim(0, -1)
    return all_gather_last(moved, grid.tp_group).movedim(-1, 0).contiguous()


def gather_train_state(state, grid: Grid) -> dict:
    """{"model": full state_dict, "optimizer": full optimizer state_dict},
    on the CPU, from every tp rank's slices (one all-gather over the tp group
    for each split leaf; every rank calls it). The inverse of
    shard_train_state: what a tp-1 run of the same state holds."""
    model, shardings = state.model, getattr(state, "shardings", None) or {}
    full = {}
    for name, t in model.state_dict().items():
        full[name] = (gather_leaf(t, grid) if shardings.get(name) else t.detach()).cpu()
    opt = state.optimizer.state_dict()
    names = [n for n, _ in model.named_parameters()]
    opt_state = {}
    for i, entry in opt["state"].items():
        split = shardings.get(names[int(i)], False)
        opt_state[i] = {k: (gather_leaf(v, grid) if split and torch.is_tensor(v) and v.dim() else v)
                        for k, v in entry.items()}
        opt_state[i] = {k: v.cpu() if torch.is_tensor(v) else v for k, v in opt_state[i].items()}
    return {"model": full, "optimizer": {**opt, "state": opt_state}}
