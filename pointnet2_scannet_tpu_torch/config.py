"""Typed run configuration, read from and written to a run dir's config.json.

The same dataclasses and field names as the JAX package's config.py, so a
config.json that either package wrote loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

# ScanNet v2 semantic label set: 20 NYU classes, stored as 0..19 indices.
NYU_CLASSES = (
    "floor", "wall", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "bathtub", "shower curtain", "toilet", "sink", "otherprop",
)
NUM_CLASSES = len(NYU_CLASSES)

# RGB palette for PLY visualization, one colour per class.
PALETTE = (
    (152, 223, 138), (174, 199, 232), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
    (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
    (247, 182, 210), (219, 219, 141), (255, 127, 14), (227, 119, 194),
    (158, 218, 229), (44, 160, 44), (112, 128, 144), (82, 84, 163),
)

# Preprocessed scene column layout, (N, 11):
# [x, y, z, r, g, b, nx, ny, nz, instance_label, semantic_label]
SCENE_COLUMNS = 11


@dataclasses.dataclass(frozen=True)
class PathConfig:
    scannet_dir: str = "data/scannet"
    scans_dir: str = "data/scannet/scans"
    preprocessed_dir: str = "data/preprocessed_scenes"
    multiview_h5: str = "data/enet_feats.hdf5"
    output_root: str = "outputs"
    train_list: str = "data/scannetv2_train.txt"
    val_list: str = "data/scannetv2_val.txt"
    test_list: str = "data/scannetv2_test.txt"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    npoints: int = 8192
    chunk_size_xy: float = 1.5  # column footprint, meters
    chunk_margin: float = 0.2
    chunk_retries: int = 5
    min_annotated_frac: float = 0.7
    min_voxel_occupancy: float = 0.02
    is_weighting: bool = True
    use_color: bool = False
    use_normal: bool = False
    use_multiview: bool = False
    augment: bool = True

    @property
    def input_channels(self) -> int:
        """Feature channels beyond xyz."""
        return 3 * self.use_color + 3 * self.use_normal + 128 * self.use_multiview


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_classes: int = NUM_CLASSES
    is_msg: bool = False
    use_xyz: bool = True
    bn: bool = True
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training fields of a run, as the JAX package's config.json holds
    them."""

    batch_size: int = 32
    epochs: int = 500
    lr: float = 1e-3
    weight_decay: float = 0.0
    decay_step: int = 100
    decay_factor: float = 0.7
    verbose: int = 10
    seed: int = 0
    no_weighting: bool = False
    num_devices: int | None = None
    tp: int = 1
    shuffle: bool = False
    device_store: bool = False
    fused_steps: int = 1
    wholescene: bool = False
    synthetic: bool = False
    synthetic_scenes: int = 8
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything needed to rebuild a run: serialized into the run dir."""

    tag: str = "run"
    paths: PathConfig = dataclasses.field(default_factory=PathConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        raw: dict[str, Any] = json.loads(text)
        return cls(
            tag=raw.get("tag", "run"),
            paths=PathConfig(**raw.get("paths", {})),
            data=DataConfig(**raw.get("data", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
        )

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "RunConfig":
        return cls.from_json(pathlib.Path(path).read_text())
