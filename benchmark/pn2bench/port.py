"""What the benchmark's drivers take from the program
(pointnet2_scannet_tpu_torch) beside the model, which a builder makes
(pn2bench/builders/): the train state and fused step, the HostGroup, the
optimizer's moments. With the builders, the only modules of the benchmark
that import the program.

The weights are the benchmark's (make_params): drawn on the device from the
seed in one call and copied into the program's model, so the reference gets
the very same tensors.
"""

from __future__ import annotations

import math

import torch


def make_params(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """The benchmark's weights for the model's state: every Linear weight
    (out, in) normal with standard deviation sqrt(2 / in), clipped at two
    deviations, drawn in one call from a generator on the model's device;
    BatchNorm at identity (scale 1, shift 0, running mean 0, variance 1)."""
    state = model.state_dict()
    device = next(model.parameters()).device
    dense = [k for k, v in state.items() if v.dim() == 2]
    total = sum(state[k].numel() for k in dense)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    params, o = {}, 0
    for k, v in state.items():
        if k in dense:
            n = v.numel()
            params[k] = draw[o:o + n].view_as(v) * math.sqrt(2.0 / v.shape[1])
            o += n
        elif k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            params[k] = torch.ones_like(v)
        elif k.endswith("num_batches_tracked"):
            continue
        else:
            params[k] = torch.zeros_like(v)
    return params


def load_params(model: torch.nn.Module, params: dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in params:
                v.copy_(params[k])


def fused_train(model, *, lr: float, decay_step_epochs: int, decay_factor: float, steps_per_epoch: int,
                weight_decay: float, dropout_seed: int, num_classes: int):
    """(train state, fused step) as scripts/train_torch.py builds them for
    --fused_steps K on one card (parallel/step.make_fused_train_step)."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.parallel.step import make_fused_train_step

    schedule = ts.make_lr_schedule(lr, decay_step_epochs, decay_factor, steps_per_epoch)
    state = ts.create_train_state(model, schedule, weight_decay=weight_decay, seed=dropout_seed)
    return state, make_fused_train_step(model, None, num_classes=num_classes)


def host_group(batches: list[dict], pin: bool):
    from pointnet2_scannet_tpu_torch.data.pipeline import HostGroup

    return HostGroup(batches, pin=pin)


def adam_moments(state) -> dict[str, torch.Tensor]:
    """Each parameter's first moment (exp_avg) by its name; zeros for a
    parameter the optimizer never stepped."""
    opt = state.optimizer
    return {name: opt.state[p]["exp_avg"] if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
            for name, p in state.model.named_parameters()}


def capture_launches(fused) -> dict[str, int]:
    """The launch counts of the port's kernels that the first capture
    recorded (FusedTrainStep.captures)."""
    return dict(fused.captures[0]["launches"]) if fused.captures else {}
