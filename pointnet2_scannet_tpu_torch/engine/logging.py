"""Per-epoch scalar log of a run: `<run>/tensorboard/all_scalars.json`, and
TensorBoard event files beside it where a writer is installed.

The JAX package's ScalarLogger: the JSON is the source of truth; the events
come from tensorboardX, or else from torch.utils.tensorboard (which needs
the tensorboard package), and are skipped where neither imports.
"""

from __future__ import annotations

import json
import pathlib
from collections import defaultdict


def _summary_writer(log_dir: pathlib.Path):
    """A SummaryWriter into log_dir, or None where no writer is installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(str(log_dir))


class ScalarLogger:
    def __init__(self, output_dir: str | pathlib.Path):
        self.output_dir = pathlib.Path(output_dir)
        # tag -> [(step, value), ...]
        self.scalars: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self._writer = _summary_writer(self.output_dir / "tensorboard")

    def add_scalars(self, prefix: str, values: dict[str, float], step: int) -> None:
        for k, v in values.items():
            tag = f"{prefix}/{k}"
            self.scalars[tag].append((step, float(v)))
            if self._writer is not None:
                self._writer.add_scalar(tag, float(v), step)

    def export(self) -> pathlib.Path:
        path = self.output_dir / "tensorboard" / "all_scalars.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.scalars, indent=2))
        if self._writer is not None:
            self._writer.flush()
        return path

    def close(self) -> None:
        """Export, and close the event writer."""
        self.export()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
