"""Serving: the eval-mode forward and a Predictor over ragged column stacks.

The port's counterpart of the JAX package's engine/export.py build_forward
and ServingPredictor. The model runs eagerly on the given device under
torch.inference_mode(); an exported artifact (torch.export) is ROADMAP queue
1, item 14.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import NUM_CLASSES, RunConfig
from pointnet2_scannet_tpu_torch.engine.metrics import pred_transfer_dtype


def build_forward(model: torch.nn.Module, *, emit: str = "labels",
                  num_classes: int = NUM_CLASSES):
    """points (B, N, C) -> labels (B, N) in the narrowest integer dtype, or
    logits (B, N, num_classes) with emit="logits"."""
    if emit not in ("labels", "logits"):
        raise ValueError(f"emit must be 'labels' or 'logits', got {emit!r}")
    pred_dtype = pred_transfer_dtype(num_classes)

    def fwd(points: torch.Tensor) -> torch.Tensor:
        logits = model(points)
        if emit == "labels":
            return torch.argmax(logits, dim=-1).to(pred_dtype)
        return logits

    return fwd


def run_kind(raw_config: dict) -> str:
    """'semseg' for a run dir written by scripts/train.py (a nested
    RunConfig); 'partseg' or 'cls' for the shape-family trainers."""
    if "model" in raw_config and "data" in raw_config:
        return "semseg"
    return "partseg" if "num_parts" in raw_config else "cls"


def load_run_model(run_dir: str | pathlib.Path, checkpoint: str = "model_best"):
    """(model on the CPU, RunConfig) of a semantic-segmentation run dir:
    config.json names the model and its compute dtype, <checkpoint>.pt
    holds its state_dict (float32 in either dtype), which must fit it
    exactly."""
    from pointnet2_scannet_tpu_torch.engine.checkpoint import load_state_dict
    from pointnet2_scannet_tpu_torch.models.pointnet2 import model_from_config

    run_dir = pathlib.Path(run_dir)
    kind = run_kind(json.loads((run_dir / "config.json").read_text()))
    if kind != "semseg":
        raise ValueError(f"{run_dir} holds a {kind} run; only semseg serves here")
    cfg = RunConfig.load(run_dir / "config.json")
    model = model_from_config(cfg)
    model.load_state_dict(load_state_dict(run_dir, checkpoint), strict=True)
    return model, cfg


class Predictor:
    """Run the eval forward over (S, npoints, channels) column stacks.

    predict() pads S to a multiple of batch_size with repeats of the last
    column, runs each batch on `device`, and trims the output back to S.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        batch_size: int,
        npoints: int,
        channels: int,
        device: torch.device | str,
        emit: str = "labels",
        num_classes: int = NUM_CLASSES,
    ):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.npoints = npoints
        self.channels = channels
        self.emit = emit
        self.num_classes = num_classes
        self._fwd = build_forward(self.model, emit=emit, num_classes=num_classes)

    @classmethod
    def from_run(
        cls,
        run_dir: str | pathlib.Path,
        *,
        checkpoint: str = "model_best",
        batch_size: int = 32,
        npoints: int | None = None,
        emit: str = "labels",
        device: torch.device | str = "cuda",
    ) -> "Predictor":
        """A semantic-segmentation run dir: config.json + <checkpoint>.pt."""
        model, cfg = load_run_model(run_dir, checkpoint)
        return cls(
            model,
            batch_size=batch_size,
            npoints=npoints if npoints is not None else cfg.data.npoints,
            channels=3 + cfg.data.input_channels,
            device=device,
            emit=emit,
            num_classes=cfg.model.num_classes,
        )

    def predict(self, columns: np.ndarray) -> np.ndarray:
        """(S, npoints, channels) float32 -> outputs with leading S."""
        columns = np.asarray(columns, np.float32)
        if columns.ndim != 3 or columns.shape[1:] != (self.npoints, self.channels):
            raise ValueError(
                f"expected (S, {self.npoints}, {self.channels}), got {columns.shape}"
            )
        s = columns.shape[0]
        b = self.batch_size
        if s == 0:
            tail = (self.npoints,) if self.emit == "labels" else (self.npoints, self.num_classes)
            dtype = pred_transfer_dtype(self.num_classes) if self.emit == "labels" else torch.float32
            return torch.zeros((0, *tail), dtype=dtype).numpy()
        pad = (-s) % b
        if pad:
            columns = np.concatenate([columns, np.repeat(columns[-1:], pad, 0)])
        outs = []
        with torch.inference_mode():
            for i in range(0, len(columns), b):
                x = torch.from_numpy(columns[i : i + b]).to(self.device)
                outs.append(self._fwd(x).cpu().numpy())
        return np.concatenate(outs)[:s]
