"""The program's PointNet++ segmentation model (models.get_model, SSG or
MSG by "is_msg"), built on the device and checked against every size the
configuration's "model" entry states."""

from __future__ import annotations

import torch


def build(model_cfg: dict, device: torch.device) -> torch.nn.Module:
    import pointnet2_scannet_tpu_torch  # noqa: F401  (TF32 off)
    from pointnet2_scannet_tpu_torch.models import get_model

    model = get_model(model_cfg["num_classes"], is_msg=model_cfg["is_msg"],
                      input_channels=model_cfg["input_channels"], use_xyz=model_cfg["use_xyz"],
                      bn=model_cfg["bn"], device=device)
    spec = model.spec
    got = {"npoints": list(spec.npoints), "radii": [list(r) for r in spec.radii],
           "nsamples": [list(k) for k in spec.nsamples],
           "sa_mlps": [[list(w) for w in lvl] for lvl in spec.sa_mlps],
           "fp_mlps": [list(w) for w in spec.fp_mlps], "cls_fc": list(spec.cls_fc), "dropout": spec.dropout}
    for key, value in got.items():
        if model_cfg[key] != value:
            raise ValueError(f"the program's model differs from the configuration at {key}: {value} "
                             f"against {model_cfg[key]}")
    return model
