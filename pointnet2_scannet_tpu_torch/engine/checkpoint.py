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
) -> pathlib.Path:
    """Write a TrainState (engine/train_state.py) as `<name>.pt`,
    `<name>.train.pt` and `<name>.meta.json`."""
    directory = pathlib.Path(directory)
    path = save_state_dict(directory, name, state.model.state_dict())
    torch.save(
        {
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "generator": state.generator.get_state(),
        },
        directory / f"{name}.train.pt",
    )
    meta = {"epoch": epoch, "best": best or {}}
    (directory / f"{name}.meta.json").write_text(json.dumps(meta, indent=2))
    return path


def restore_checkpoint(directory: str | pathlib.Path, name: str, state) -> dict[str, Any]:
    """Load a checkpoint into an existing TrainState in place; returns the
    meta dict ("epoch", "best")."""
    directory = pathlib.Path(directory)
    state.model.load_state_dict(load_state_dict(directory, name), strict=True)
    train = torch.load(directory / f"{name}.train.pt", map_location="cpu", weights_only=True)
    state.optimizer.load_state_dict(train["optimizer"])
    state.step = int(train["step"])
    state.generator.set_state(train["generator"])
    meta_path = directory / f"{name}.meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
