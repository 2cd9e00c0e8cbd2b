"""Checkpoints in a run dir.

`<dir>/<name>.pt` holds the model's state_dict alone, so Predictor.from_run
and scripts/infer_torch.py load any checkpoint a run wrote. A training
checkpoint adds `<dir>/<name>.train.pt` (optimizer state, optimizer step,
Dropout generator state) and `<dir>/<name>.meta.json` (epoch and best
metrics), which together restore the full train state for a resume.

A tensor-parallel run (parallel/mesh.py) writes the same files: its
coordinator saves the state that parallel/mesh.gather_train_state rebuilt
from every tp rank's slices, which is what a tp-1 run of that state holds,
so eval_torch.py, infer_torch.py, convert.py and a resume at any --tp read
it unchanged; a restore onto a grid takes this rank's slices again (the
JAX Solver's resume re-shards, solver.py:498-503).
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch


def save_state_dict(directory: str | pathlib.Path, name: str, state_dict) -> pathlib.Path:
    """Write a state_dict of tensors or numpy arrays to `<dir>/<name>.pt`."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tensors = {
        k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
        else v.detach().cpu()
        for k, v in state_dict.items()
    }
    path = directory / f"{name}.pt"
    torch.save(tensors, path)
    return path


def load_state_dict(directory: str | pathlib.Path, name: str) -> dict[str, torch.Tensor]:
    """Read `<dir>/<name>.pt` onto the CPU (tensors only, no pickled code)."""
    path = pathlib.Path(directory) / f"{name}.pt"
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(
    directory: str | pathlib.Path,
    name: str,
    state,
    *,
    epoch: int,
    best: dict[str, Any] | None = None,
    generators: list[torch.Tensor] | None = None,
    full: dict | None = None,
) -> pathlib.Path:
    """Write a TrainState (engine/train_state.py) as `<name>.pt`,
    `<name>.train.pt` and `<name>.meta.json`. generators: every dp rank's
    Dropout generator state in a data-parallel run, in dp order. full: the
    {"model", "optimizer"} state_dicts of a tensor-parallel state gathered
    whole (parallel/mesh.gather_train_state), written in place of the
    state's own slices."""
    directory = pathlib.Path(directory)
    full = full or {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict()}
    path = save_state_dict(directory, name, full["model"])
    train = {
        "optimizer": _portable(full["optimizer"]),
        "step": state.step,
        "generator": state.generator.get_state(),
    }
    if generators is not None:
        train["generators"] = generators
    torch.save(train, directory / f"{name}.train.pt")
    meta = {"epoch": epoch, "best": best or {}}
    (directory / f"{name}.meta.json").write_text(json.dumps(meta, indent=2))
    return path


def _portable(optimizer_state: dict) -> dict:
    """An optimizer state_dict whose learning rates are floats (a capturable
    optimizer holds its rate as a device tensor), so that a run resumes on
    either device."""
    for group in optimizer_state["param_groups"]:
        if torch.is_tensor(group["lr"]):
            group["lr"] = float(group["lr"])
    return optimizer_state


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Load a saved optimizer state into optimizer, keeping this optimizer's
    mode (capturable on a card, with its learning-rate tensor; foreach)
    whatever the saving run's: each step count then lies on the device that
    mode wants."""
    kept = [{k: g[k] for k in ("lr", "capturable", "foreach")} for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, keep in zip(optimizer.param_groups, kept):
        group.update(keep)
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device if group["capturable"] else "cpu")


def restore_checkpoint(directory: str | pathlib.Path, name: str, state, rank: int = 0,
                       grid=None) -> dict[str, Any]:
    """Load a checkpoint into an existing TrainState in place; returns the
    meta dict ("epoch", "best"). rank: the dp rank whose Dropout generator
    state to restore; a rank the checkpoint holds none for (a run resumed
    on more ranks) keeps its generator as seeded. grid: a tensor-parallel
    state's parallel/mesh.Grid: the whole tensors are sliced onto it
    (state.shardings says which), whatever --tp wrote them."""
    from pointnet2_scannet_tpu_torch.parallel import mesh

    directory = pathlib.Path(directory)
    model_state = load_state_dict(directory, name)
    train = torch.load(directory / f"{name}.train.pt", map_location="cpu", weights_only=True)
    optimizer_state = train["optimizer"]
    if state.shardings is not None:
        model_state = mesh.shard_state_dict(model_state, state.shardings, grid)
        optimizer_state = mesh.shard_optimizer_state(optimizer_state, state.model, state.shardings, grid)
    state.model.load_state_dict(model_state, strict=True)
    _load_optimizer(state.optimizer, optimizer_state)
    state.step = int(train["step"])
    generators = train.get("generators") or [train["generator"]]
    if rank < len(generators):
        state.generator.set_state(generators[rank])
    meta_path = directory / f"{name}.meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
