"""Evaluate a shape-classification or part-segmentation run of the PyTorch +
CUDA port, the counterpart of scripts/eval_shapes.py, with --device.

Every model and data flag comes from the run dir's config.json (written by
scripts/train_cls_torch.py or train_partseg_torch.py), never retyped, and
the kind is read from it. The fresh batches are drawn at seed + 20_000,
disjoint from the trainer's validation set (seed + 10_000).

  cls      overall accuracy and a per-class accuracy table from the
           confusion matrix;
  partseg  point accuracy, the confusion part mIoU, the instance- and
           category-average mIoU pair and a per-category table;
           --dump_ply N writes the first N clouds as ascii PLYs, coloured by
           predicted and by true part, to <run>/preds/.

  python scripts/eval_shapes_torch.py --folder outputs_cls/<run>
  python scripts/eval_shapes_torch.py --folder outputs_partseg/<run> --dump_ply 4 --device cpu
  python scripts/eval_shapes_torch.py --folder outputs_cls/<run> --num_devices 2 --device cpu
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pointnet2_scannet_tpu_torch.engine import shape_runs  # noqa: E402

parse_args = shape_runs.parse_eval_args


def main(argv=None):
    return shape_runs.eval_main(argv)


if __name__ == "__main__":
    main()
