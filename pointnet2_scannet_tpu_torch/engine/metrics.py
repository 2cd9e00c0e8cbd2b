"""The host metrics of the serving path: coordinate dedup and the narrowest
label dtype."""

from __future__ import annotations

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.utils import native


def pred_transfer_dtype(num_classes: int) -> torch.dtype:
    """Narrowest integer dtype that holds a class id (labels travel to the
    host at int8 when they fit)."""
    return torch.int8 if num_classes <= 127 else torch.int32


def filter_points(coords, preds, targets, weights):
    """Keep the first occurrence of every unique coordinate row."""
    ids = native.coord_first_occurrence(np.asarray(coords, np.float32))
    return coords[ids], preds[ids], targets[ids], weights[ids]
