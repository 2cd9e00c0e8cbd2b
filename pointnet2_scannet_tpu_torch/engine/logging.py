"""Per-epoch scalar log of a run, exported as JSON.

The JAX package's ScalarLogger writes TensorBoard events when tensorboardX is
installed and always `<run>/tensorboard/all_scalars.json`; the JSON is its
source of truth, and the port writes only that, at the same path.
"""

from __future__ import annotations

import json
import pathlib
from collections import defaultdict


class ScalarLogger:
    def __init__(self, output_dir: str | pathlib.Path):
        self.output_dir = pathlib.Path(output_dir)
        # tag -> [(step, value), ...]
        self.scalars: dict[str, list[tuple[int, float]]] = defaultdict(list)

    def add_scalars(self, prefix: str, values: dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalars[f"{prefix}/{k}"].append((step, float(v)))

    def export(self) -> pathlib.Path:
        path = self.output_dir / "tensorboard" / "all_scalars.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.scalars, indent=2))
        return path
