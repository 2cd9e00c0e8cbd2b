"""Serving: the eval-mode forward, a Predictor over ragged column stacks, and
ahead-of-time artifacts of the forward (torch.export).

The port's counterpart of the JAX package's engine/export.py. Predictor runs
the model eagerly on the given device under torch.inference_mode().
export_forward traces the same forward with torch.export into one program
(the weights go with it), save_exported / load_exported write and read it,
export_run does both halves for a run dir, and ServingPredictor serves a
program over ragged column stacks on one device or round-robin over several.

Every model family serves: semantic segmentation (scripts/train_torch.py
run dirs), and the shape families, classification and part segmentation
(scripts/train_cls_torch.py, train_partseg_torch.py), told apart by the
run's config.json (run_kind).

Artifact contract (fixed shapes: one traced program, not a shape family):
  input   (batch, npoints, channels) float32 point columns (cls: xyz;
          partseg: xyz and the category one-hot)
  output  emit="labels": (batch, npoints) int8 (int32 if num_classes > 127)
          class or part ids; (batch,) class ids for cls
          emit="logits": (batch, npoints, num_classes) float32 logits;
          (batch, num_classes) for cls

Where a JAX artifact is self-contained StableHLO, a port artifact calls the
port's kernels: every kernel of the forward is one pn2:: torch.library op
(ops/library.py), so the serving process imports this package (load_exported
does) and builds the kernels from csrc/ on its first launch on the card.

The program runs the ATen ops the eager forward runs (no decompositions), so
its outputs equal Predictor's bit for bit on the device it was traced on. Its
routes are fixed when it is traced, by the trace device (the first of
`platforms`): a program traced on the CPU takes the CPU's routes on the
card too, so its gathers take route "xla" (kernel d, as the card's "vmem"
route does) and every 3-NN takes three_nn (kernel i), where a program traced
on the card runs three_nn_q (kernel j) at 7936-point columns. The functions
are equal; the kernels launched differ.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pathlib

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import NUM_CLASSES, RunConfig
from pointnet2_scannet_tpu_torch.engine.metrics import pred_transfer_dtype

PLATFORMS = ("cpu", "cuda")
_META = "pn2_artifact.json"  # the artifact's extra file: platforms, trace device, switches


def build_forward(model: torch.nn.Module, *, emit: str = "labels",
                  num_classes: int = NUM_CLASSES):
    """points (B, N, C) -> labels (B, N) in the narrowest integer dtype, or
    logits (B, N, num_classes) with emit="logits" (a classifier: (B,) and
    (B, num_classes))."""
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
    """(model on the CPU, config) of a run dir: config.json names the model
    and its compute dtype, <checkpoint>.pt holds its state_dict (float32 in
    either dtype), which must fit it exactly. The config is a RunConfig for
    a semantic-segmentation run and the flat dict of a shape trainer's
    config.json for a cls or partseg run (engine/shape_runs.py)."""
    from pointnet2_scannet_tpu_torch.engine.checkpoint import load_state_dict
    from pointnet2_scannet_tpu_torch.models.pointnet2 import model_from_config

    run_dir = pathlib.Path(run_dir)
    raw = json.loads((run_dir / "config.json").read_text())
    if run_kind(raw) == "semseg":
        cfg = RunConfig.load(run_dir / "config.json")
        model = model_from_config(cfg)
    else:
        from pointnet2_scannet_tpu_torch.engine.shape_runs import model_from_flat_config

        cfg = raw
        model = model_from_flat_config(raw)
    model.load_state_dict(load_state_dict(run_dir, checkpoint), strict=True)
    return model, cfg


def serving_shape(cfg) -> tuple[int, int, int]:
    """(npoints, channels, num_classes) of a load_run_model config: the
    run's training column size, its input channels (a shape run: xyz, and
    for partseg the category one-hot) and its output classes (or parts)."""
    if isinstance(cfg, RunConfig):
        return cfg.data.npoints, 3 + cfg.data.input_channels, cfg.model.num_classes
    if run_kind(cfg) == "partseg":
        return int(cfg["npoints"]), 3 + int(cfg["categories"]), int(cfg["num_parts"])
    return int(cfg["npoints"]), 3, int(cfg["classes"])


def _pad(columns: np.ndarray, shape: tuple[int, int], batch_size: int) -> tuple[np.ndarray, int]:
    """Check an (S, *shape) stack and pad S to a multiple of batch_size with
    repeats of the last column; returns (padded float32 stack, S)."""
    columns = np.asarray(columns, np.float32)
    if columns.ndim != 3 or columns.shape[1:] != shape:
        raise ValueError(f"expected (S, {shape[0]}, {shape[1]}), got {columns.shape}")
    s = columns.shape[0]
    pad = (-s) % batch_size
    if s and pad:
        columns = np.concatenate([columns, np.repeat(columns[-1:], pad, 0)])
    return columns, s


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
        from pointnet2_scannet_tpu_torch.models import PointNet2Cls

        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.npoints = npoints
        self.channels = channels
        self.emit = emit
        self.num_classes = num_classes
        self.pointwise = not isinstance(model, PointNet2Cls)  # a classifier emits a row a column
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
        """A run dir of any family: config.json + <checkpoint>.pt."""
        model, cfg = load_run_model(run_dir, checkpoint)
        run_npoints, channels, num_classes = serving_shape(cfg)
        return cls(
            model,
            batch_size=batch_size,
            npoints=npoints if npoints is not None else run_npoints,
            channels=channels,
            device=device,
            emit=emit,
            num_classes=num_classes,
        )

    def predict(self, columns: np.ndarray) -> np.ndarray:
        """(S, npoints, channels) float32 -> outputs with leading S."""
        columns, s = _pad(columns, (self.npoints, self.channels), self.batch_size)
        if s == 0:
            tail = (self.npoints,) * self.pointwise + (self.num_classes,) * (self.emit == "logits")
            dtype = pred_transfer_dtype(self.num_classes) if self.emit == "labels" else torch.float32
            return torch.zeros((0, *tail), dtype=dtype).numpy()
        b = self.batch_size
        outs = []
        with torch.inference_mode():
            for i in range(0, len(columns), b):
                x = torch.from_numpy(columns[i : i + b]).to(self.device)
                outs.append(self._fwd(x).cpu().numpy())
        return np.concatenate(outs)[:s]


# ------------------------------------------------------------ artifacts


@dataclasses.dataclass
class Exported:
    """A traced eval forward (torch.export.ExportedProgram) and what it was
    traced under: the platforms it may run on, the device it was traced on
    (the first platform) and the op-lowering switches (ops/tuning.py)."""

    program: torch.export.ExportedProgram
    platforms: tuple[str, ...]
    device: str
    ops_config: dict

    @property
    def in_shape(self) -> tuple[int, ...]:
        (node,) = (n for n in self.program.graph.nodes
                   if n.op == "placeholder" and n.name in self.program.graph_signature.user_inputs)
        return tuple(int(d) for d in node.meta["val"].shape)

    @property
    def out_meta(self) -> tuple[tuple[int, ...], torch.dtype]:
        """(shape, dtype) of the program's output."""
        (out,) = (n for n in self.program.graph.nodes if n.op == "output")
        val = out.args[0][0].meta["val"]
        return tuple(int(d) for d in val.shape), val.dtype

    @property
    def num_nodes(self) -> int:
        return len(self.program.graph.nodes)


class _Forward(torch.nn.Module):
    """build_forward as a module, which torch.export traces."""

    def __init__(self, model: torch.nn.Module, emit: str, num_classes: int):
        super().__init__()
        self.model = model
        self._fwd = build_forward(model, emit=emit, num_classes=num_classes)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        return self._fwd(points)


def _platforms(platforms) -> tuple[str, ...]:
    platforms = tuple(platforms) if platforms else ("cuda",)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {bad}")
    return platforms


def export_forward(
    model: torch.nn.Module,
    *,
    batch_size: int,
    npoints: int,
    channels: int,
    emit: str = "labels",
    num_classes: int = NUM_CLASSES,
    platforms: list[str] | None = None,
) -> Exported:
    """Trace the eval forward of a copy of model (on the first of
    `platforms`, the card by default, in eval mode) at (batch_size, npoints,
    channels) float32 with torch.export (non-strict, no decompositions).

    platforms: where the artifact may run ("cpu", "cuda"); a program traced
    on one runs on the others after ServingPredictor moves it."""
    from pointnet2_scannet_tpu_torch.ops import tuning

    platforms = _platforms(platforms)
    device = torch.device(platforms[0])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    module = _Forward(copy.deepcopy(model).to(device).eval(), emit, num_classes)
    example = torch.zeros((batch_size, npoints, channels), dtype=torch.float32, device=device)
    program = torch.export.export(module, (example,), strict=False)
    program.example_inputs = None  # else the artifact carries a batch of zeros
    return Exported(program, platforms, str(device), dataclasses.asdict(tuning.ops_config))


def save_exported(exported: Exported, path: str | pathlib.Path) -> pathlib.Path:
    """torch.export.save of the program, with its platforms, trace device and
    switches in an extra file."""
    path = pathlib.Path(path)
    meta = {"platforms": list(exported.platforms), "device": exported.device,
            "ops_config": exported.ops_config}
    torch.export.save(exported.program, path, extra_files={_META: json.dumps(meta)})
    return path


def load_exported(path: str | pathlib.Path) -> Exported:
    """torch.export.load of an artifact that save_exported wrote. Imports
    the port's op library first: the program calls its pn2:: ops, whose
    kernels build from csrc/ at their first launch on the card."""
    from pointnet2_scannet_tpu_torch.ops import library  # noqa: F401  (registers pn2::)

    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    return Exported(program, tuple(meta["platforms"]), meta["device"], meta["ops_config"])


def export_run(
    run_dir: str | pathlib.Path,
    *,
    checkpoint: str = "model_best",
    batch_size: int = 32,
    npoints: int | None = None,
    emit: str = "labels",
    platforms: list[str] | None = None,
) -> Exported:
    """Export a run dir of any family (config.json + <checkpoint>.pt) at
    the run's training npoints unless given: a labels artifact emits (B,
    npoints) class or part ids for the segmentation families and (B,) class
    ids for cls."""
    model, cfg = load_run_model(run_dir, checkpoint)
    run_npoints, channels, num_classes = serving_shape(cfg)
    return export_forward(
        model,
        batch_size=batch_size,
        npoints=npoints if npoints is not None else run_npoints,
        channels=channels,
        emit=emit,
        num_classes=num_classes,
        platforms=platforms,
    )


class ServingPredictor:
    """Run an exported forward over ragged column stacks.

    The program is fixed at (B, N, C); predict() pads an (S, N, C) stack to
    a multiple of B with repeats of the last column and trims the outputs
    back. devices (default: the card) must be among the artifact's
    platforms, else the constructor raises before it touches any device; a
    program traced on another device is moved to each
    (torch.export.passes.move_to_device_pass). Batches go round-robin over
    devices: every batch is enqueued before any output is fetched, so the
    cards work while the host feeds the later batches. The program is
    batch-parallel with no cross-batch state, so no collective is needed.
    """

    def __init__(self, exported: Exported, devices=None):
        from torch.export.passes import move_to_device_pass

        self.exported = exported
        self.batch_size, self.npoints, self.channels = exported.in_shape
        devices = [torch.device(d) for d in (devices or ["cuda"])]
        refused = sorted({d.type for d in devices if d.type not in exported.platforms})
        if refused:
            raise ValueError(
                f"artifact exported for platforms {list(exported.platforms)}; "
                f"cannot serve on {refused}")
        self.devices = [
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in devices
        ]
        self._modules = {}
        for d in self.devices:
            key = str(d)
            if key not in self._modules:
                program = exported.program
                if key != exported.device:
                    program = move_to_device_pass(copy.deepcopy(program), d)
                self._modules[key] = program.module()

    @classmethod
    def from_artifact(cls, path: str | pathlib.Path, devices=None) -> "ServingPredictor":
        return cls(load_exported(path), devices=devices)

    def predict(self, columns: np.ndarray) -> np.ndarray:
        """(S, npoints, channels) float32 -> stacked outputs with leading S."""
        columns, s = _pad(columns, (self.npoints, self.channels), self.batch_size)
        if s == 0:
            shape, dtype = self.exported.out_meta
            return torch.zeros((0, *shape[1:]), dtype=dtype).numpy()
        b = self.batch_size
        with torch.inference_mode():
            outs = []
            for k, i in enumerate(range(0, len(columns), b)):
                d = self.devices[k % len(self.devices)]
                outs.append(self._modules[str(d)](torch.from_numpy(columns[i : i + b]).to(d)))
            return np.concatenate([o.cpu().numpy() for o in outs])[:s]
