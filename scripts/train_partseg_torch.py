"""Part-segmentation training CLI of the PyTorch + CUDA port
(pointnet2_scannet_tpu_torch), the counterpart of scripts/train_partseg.py with
its flags, defaults and run-dir layout, and --device.

Trains PointNet2PartSeg (SSG, or MSG with --use_msg; --bf16 computes in
bfloat16) on the synthetic parametric shapes of data/shapes.py with
per-point global part labels (each category a block of part ids) and the
category one-hot as the input's last channels, with the segmentation
engine's train and eval steps, on --device (the hand-written CUDA kernels
on a GPU, their plain PyTorch versions on the CPU). Each epoch reports the
point accuracy, the confusion part mIoU and the instance / category mIoU.
Writes <output_root>/<stamp>_<TAG>/ with config.json (with num_parts),
info.json, model_best.pt (gated on the val part mIoU), model_last.pt (each
with .train.pt / .meta.json resume state) and all_scalars.json;
engine/shape_runs.py has the details.

  python scripts/train_partseg_torch.py                         # 20 epochs, batch 16 x 1024, the card
  python scripts/train_partseg_torch.py --use_msg --bf16
  python scripts/train_partseg_torch.py --device cpu --batch_size 4 --npoints 512 --categories 4 --epoch 1 \\
      --train_batches 2 --val_batches 1
  python scripts/train_partseg_torch.py --resume outputs_partseg/<run> --epoch 30
  python scripts/train_partseg_torch.py --num_devices 2 --device cpu ...   # two gloo ranks
  python scripts/eval_shapes_torch.py --folder outputs_partseg/<run>
  python scripts/infer_torch.py --folder outputs_partseg/<run> --export partseg.pt2   # (B, N) part ids
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pointnet2_scannet_tpu_torch.engine import shape_runs  # noqa: E402

def parse_args(argv=None):
    return shape_runs.parse_args("partseg", argv)


def main(argv=None):
    return shape_runs.main("partseg", argv)


if __name__ == "__main__":
    main()
