"""Shape-classification training CLI of the PyTorch + CUDA port
(pointnet2_scannet_tpu_torch), the counterpart of scripts/train_cls.py with
its flags, defaults and run-dir layout, and --device.

Trains PointNet2Cls (SSG, or MSG with --use_msg; --bf16 computes in
bfloat16) on the synthetic parametric shapes of data/shapes.py with the
segmentation engine's train and eval steps, on --device (the hand-written
CUDA kernels on a GPU, their plain PyTorch versions on the CPU). Writes
<output_root>/<stamp>_<TAG>/ with config.json, info.json, model_best.pt
(gated on val accuracy), model_last.pt (each with .train.pt / .meta.json
resume state) and all_scalars.json; engine/shape_runs.py has the details.

  python scripts/train_cls_torch.py                         # 20 epochs, batch 32 x 1024, the card
  python scripts/train_cls_torch.py --use_msg --bf16
  python scripts/train_cls_torch.py --device cpu --batch_size 4 --npoints 512 --epoch 1 \\
      --train_batches 2 --val_batches 1
  python scripts/train_cls_torch.py --resume outputs_cls/<run> --epoch 30
  python scripts/train_cls_torch.py --num_devices 2 --device cpu ...   # two gloo ranks
  python scripts/eval_shapes_torch.py --folder outputs_cls/<run>
  python scripts/infer_torch.py --folder outputs_cls/<run> --export cls.pt2   # (B,) class ids
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pointnet2_scannet_tpu_torch.engine import shape_runs  # noqa: E402

def parse_args(argv=None):
    return shape_runs.parse_args("cls", argv)


def main(argv=None):
    return shape_runs.main("cls", argv)


if __name__ == "__main__":
    main()
