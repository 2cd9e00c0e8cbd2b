"""Segmentation metrics, the JAX package's engine/metrics.py.

Two tiers:
  1. Host metrics (numpy, at validation cadence): coordinate dedup, point
     and per-class accuracy, voxel and calibrated voxel accuracy, point and
     voxel per-class IoU over 0.02 m surface voxels, each voxel labelled by
     one representative point.
  2. The confusion matrix of a batch, an exact integer count made on the
     batch's device inside the train and eval steps, so training never
     copies predictions to the host per step.
"""

from __future__ import annotations

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.config import NUM_CLASSES
from pointnet2_scannet_tpu_torch.utils import native
from pointnet2_scannet_tpu_torch.utils.voxel import surface_voxel_labels


def pred_transfer_dtype(num_classes: int) -> torch.dtype:
    """Narrowest integer dtype that holds a class id (labels travel to the
    host at int8 when they fit)."""
    return torch.int8 if num_classes <= 127 else torch.int32


# ------------------------------ host tier ---------------------------------


def filter_points(coords, preds, targets, weights):
    """Keep the first occurrence of every unique coordinate row."""
    ids = native.coord_first_occurrence(np.asarray(coords, np.float32))
    return coords[ids], preds[ids], targets[ids], weights[ids]


def _per_class_counts(preds, targets, num_classes):
    seen = np.bincount(targets, minlength=num_classes).astype(np.int64)
    correct = np.bincount(targets[preds == targets], minlength=num_classes).astype(np.int64)
    return seen, correct


def _dedup_and_voxelize(coords, preds, targets, weights, num_classes):
    """Unique coordinates, seen classes and the 0.02 m voxel [target, pred]
    labels: one native pass when the host library is built, else
    filter_points + surface_voxel_labels (the same sets; voxel order may
    differ, and every formula below is order-free over voxels)."""
    coords = np.asarray(coords, np.float32)
    res = 0.02
    coordmin = coords.min(axis=0) if len(coords) else np.zeros(3, np.float32)
    coordmax = coords.max(axis=0) if len(coords) else np.zeros(3, np.float32)
    nvox = np.ceil((coordmax - coordmin) / res)
    fused = native.dedup_voxelize(coords, res, coordmin, nvox)
    if fused is not None:
        keep_idx, vox_idx = fused
        uvlabel = np.stack([targets[vox_idx], preds[vox_idx]], axis=1)
        preds, targets = preds[keep_idx], targets[keep_idx]
    else:
        coords, preds, targets, weights = filter_points(coords, preds, targets, weights)
        _, uvlabel, _ = surface_voxel_labels(coords, np.stack([targets, preds], axis=1), res=res)
    seen_classes = np.flatnonzero(np.bincount(targets, minlength=num_classes))
    return preds, targets, seen_classes, uvlabel


def _acc_from(preds, targets, seen_classes, uvlabel, num_classes):
    mask = np.zeros(num_classes)
    mask[seen_classes] = 1

    pointacc = np.sum(preds == targets) / float(targets.shape[0])
    seen_pt, correct_pt = _per_class_counts(preds, targets, num_classes)

    voxacc = np.sum(uvlabel[:, 0] == uvlabel[:, 1]) / float(uvlabel.shape[0])
    seen_vox, correct_vox = _per_class_counts(uvlabel[:, 1], uvlabel[:, 0], num_classes)

    # calibrated: per-class voxel accuracy averaged with voxel label frequencies
    caliweights = seen_vox.astype(np.float64)
    caliweights = caliweights / caliweights.sum()
    voxcaliacc = np.average(correct_vox / (seen_vox.astype(np.float64) + 1e-8), weights=caliweights)

    pointacc_per_class = np.zeros(num_classes)
    voxacc_per_class = np.zeros(num_classes)
    for c in seen_classes:
        pointacc_per_class[c] = correct_pt[c] / (seen_pt[c] + 1e-8)
        voxacc_per_class[c] = correct_vox[c] / (seen_vox[c] + 1e-8)

    return pointacc, pointacc_per_class, voxacc, voxacc_per_class, voxcaliacc, mask


def _miou_from(preds, targets, seen_classes, uvlabel, num_classes):
    mask = np.zeros(num_classes)
    mask[seen_classes] = 1

    def iou(p, t):
        cm = np.bincount(t * num_classes + p, minlength=num_classes * num_classes).reshape(
            num_classes, num_classes
        )
        inter = np.diag(cm).astype(np.float64)
        union = cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm)
        out = np.zeros(num_classes)
        out[seen_classes] = inter[seen_classes] / (union[seen_classes] + 1e-8)
        return out

    return iou(preds, targets), iou(uvlabel[:, 1], uvlabel[:, 0]), mask


def compute_acc(coords, preds, targets, weights, num_classes: int = NUM_CLASSES):
    """(pointacc, pointacc_per_class, voxacc, voxacc_per_class, voxcaliacc,
    seen_mask); per-class arrays are 0 for classes absent from targets."""
    return _acc_from(*_dedup_and_voxelize(coords, preds, targets, weights, num_classes), num_classes)


def compute_miou(coords, preds, targets, weights, num_classes: int = NUM_CLASSES):
    """(pointmiou, voxmiou, seen_mask): point and voxel per-class IoU, 0 for
    classes absent from targets."""
    return _miou_from(*_dedup_and_voxelize(coords, preds, targets, weights, num_classes), num_classes)


def compute_scene_metrics(coords, preds, targets, weights, num_classes: int = NUM_CLASSES):
    """From one dedup + voxelization: ((pointacc, pointacc_per_class, voxacc,
    voxacc_per_class, voxcaliacc, seen_mask), (pointmiou, voxmiou,
    seen_mask)); per-class arrays are 0 for classes absent from targets."""
    front = _dedup_and_voxelize(coords, preds, targets, weights, num_classes)
    return _acc_from(*front, num_classes), _miou_from(*front, num_classes)


def instance_part_miou(preds, labels, category, offsets, sizes) -> tuple[float, dict[int, list[float]]]:
    """ShapeNet-part-style instance-average mIoU (the JAX package's
    metrics.py:228-270).

    preds / labels: (B, N) int GLOBAL part ids; category: (B,) int; the
    parts of category c occupy global ids [offsets[c], offsets[c] +
    sizes[c]). Per shape: the IoU of each of its category's parts (a part
    absent from both labels and predictions counts as IoU 1), averaged over
    the category's parts. Predictions are the unrestricted global argmax: a
    prediction outside the shape's block counts against the union of its
    point's true part. Returns (mean over shapes, per-category list of
    per-shape IoUs), so callers aggregate across batches shape by shape."""
    preds, labels, category = np.asarray(preds), np.asarray(labels), np.asarray(category)
    shape_ious: list[float] = []
    per_cat: dict[int, list[float]] = {}
    for i in range(preds.shape[0]):
        c = int(category[i])
        lo = int(offsets[c])
        part_ious = []
        for p in range(lo, lo + int(sizes[c])):
            gt, pd = labels[i] == p, preds[i] == p
            union = np.logical_or(gt, pd).sum()
            part_ious.append(1.0 if union == 0 else float(np.logical_and(gt, pd).sum() / union))
        iou = float(np.mean(part_ious))
        shape_ious.append(iou)
        per_cat.setdefault(c, []).append(iou)
    return (float(np.mean(shape_ious)) if shape_ious else 0.0), per_cat


def confusion_to_point_metrics(cm) -> dict[str, float]:
    """Point accuracy, mean per-class accuracy and mIoU from a confusion
    matrix (rows = target class), averaged over the classes seen."""
    cm = np.asarray(cm, np.float64)
    seen = cm.sum(axis=1)
    mask = seen > 0
    tp = np.diag(cm)
    acc = tp.sum() / max(cm.sum(), 1.0)
    per_class = np.where(mask, tp / np.maximum(seen, 1.0), 0.0)
    union = seen + cm.sum(axis=0) - tp
    iou = np.where(mask, tp / np.maximum(union, 1.0), 0.0)
    denom = max(mask.sum(), 1)
    return {
        "point_acc": float(acc),
        "point_acc_per_class": float(per_class.sum() / denom),
        "point_miou": float(iou.sum() / denom),
    }


# ----------------------------- device tier ---------------------------------


def confusion_matrix(
    preds: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int = NUM_CLASSES,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts on the batch's device, rows =
    target class. Integer scatter-adds are exact in any order, and nothing
    waits for the host. Rows with row_mask 0 are counted in a spill bin that
    is dropped."""
    k = num_classes
    flat = labels.reshape(-1).to(torch.int64) * k + preds.reshape(-1).to(torch.int64)
    if row_mask is not None:
        keep = (row_mask[:, None] > 0).expand(labels.shape).reshape(-1)
        flat = torch.where(keep, flat, torch.full_like(flat, k * k))
    counts = torch.zeros(k * k + 1, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts[: k * k].reshape(k, k)
