"""Model checkpoints: `<dir>/<name>.pt` holds a port state_dict, beside the
run's config.json."""

from __future__ import annotations

import pathlib

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
