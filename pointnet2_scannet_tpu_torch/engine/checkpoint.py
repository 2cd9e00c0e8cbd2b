"""Checkpoints in a run dir.

`<dir>/<name>.pt` holds the model's state_dict alone, so Predictor.from_run
and scripts/infer_torch.py load any checkpoint a run wrote. A training
checkpoint adds `<dir>/<name>.train.pt` (optimizer state, optimizer step,
Dropout generator state) and `<dir>/<name>.meta.json` (epoch and best
metrics), which together restore the full train state for a resume.
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
) -> pathlib.Path:
    """Write a TrainState (engine/train_state.py) as `<name>.pt`,
    `<name>.train.pt` and `<name>.meta.json`. generators: every rank's
    Dropout generator state in a data-parallel run, in rank order."""
    directory = pathlib.Path(directory)
    path = save_state_dict(directory, name, state.model.state_dict())
    train = {
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "generator": state.generator.get_state(),
    }
    if generators is not None:
        train["generators"] = generators
    torch.save(train, directory / f"{name}.train.pt")
    meta = {"epoch": epoch, "best": best or {}}
    (directory / f"{name}.meta.json").write_text(json.dumps(meta, indent=2))
    return path


def restore_checkpoint(directory: str | pathlib.Path, name: str, state, rank: int = 0) -> dict[str, Any]:
    """Load a checkpoint into an existing TrainState in place; returns the
    meta dict ("epoch", "best"). rank: the rank whose Dropout generator
    state to restore; a rank the checkpoint holds none for (a run resumed
    on more ranks) keeps its generator as seeded."""
    directory = pathlib.Path(directory)
    state.model.load_state_dict(load_state_dict(directory, name), strict=True)
    train = torch.load(directory / f"{name}.train.pt", map_location="cpu", weights_only=True)
    state.optimizer.load_state_dict(train["optimizer"])
    state.step = int(train["step"])
    generators = train.get("generators") or [train["generator"]]
    if rank < len(generators):
        state.generator.set_state(generators[rank])
    meta_path = directory / f"{name}.meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
