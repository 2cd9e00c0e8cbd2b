"""Train state and the train / eval steps, the JAX package's
engine/train_state.py.

The recipe: Adam (b1 0.9, b2 0.999, eps 1e-8) with torch-style coupled L2
weight decay, its learning rate on a staircase that decays by decay_factor
every decay_step epochs (counted in optimizer steps), the class-weighted
cross-entropy of engine/loss.py, flax-convention BatchNorm (models/layers.py)
and the confusion matrix counted on the batch's device. PyTorch runs the step
eagerly; there is no compiled step to build, so TrainState holds the model
and optimizer themselves.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from pointnet2_scannet_tpu_torch.engine.loss import weighted_cross_entropy
from pointnet2_scannet_tpu_torch.engine.metrics import confusion_matrix


def make_lr_schedule(
    lr: float, decay_step_epochs: int, decay_factor: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """optimizer step -> learning rate: lr * decay_factor ** (step // T) with
    T = decay_step_epochs * steps_per_epoch (at least 1)."""
    transition = max(decay_step_epochs * steps_per_epoch, 1)
    return lambda step: lr * decay_factor ** (step // transition)


def make_optimizer(params, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled L2 weight decay (wd * param joins the gradient before
    the moments), which the JAX package writes as add_decayed_weights then
    adam."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the learning-rate schedule, the Dropout
    generator and the number of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0


def create_train_state(
    model: torch.nn.Module,
    schedule: Callable[[int], float],
    *,
    weight_decay: float = 0.0,
    seed: int = 0,
) -> TrainState:
    """A state over `model`; the Dropout generator lives on the model's
    device and is seeded from `seed`."""
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=make_optimizer(model.parameters(), schedule(0), weight_decay),
        schedule=schedule,
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def train_step(state: TrainState, batch: dict[str, torch.Tensor], *, num_classes: int) -> dict:
    """One optimizer step on a batch of "points", "labels", "weights" and an
    optional "row_mask". Returns {"loss", "confusion"} as tensors on the
    batch's device; nothing waits for the host."""
    model = state.model
    model.train()
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    row_mask = batch.get("row_mask")
    logits = model(batch["points"], state.generator)
    loss = weighted_cross_entropy(logits, batch["labels"], batch["weights"], row_mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        cm = confusion_matrix(logits.argmax(dim=-1), batch["labels"], num_classes, row_mask)
    return {"loss": loss.detach(), "confusion": cm}


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: dict[str, torch.Tensor], *, num_classes: int) -> dict:
    """Forward with the running BatchNorm statistics and no Dropout. Returns
    {"loss", "confusion", "preds"} on the batch's device."""
    model.eval()
    row_mask = batch.get("row_mask")
    logits = model(batch["points"])
    loss = weighted_cross_entropy(logits, batch["labels"], batch["weights"], row_mask)
    preds = logits.argmax(dim=-1)
    cm = confusion_matrix(preds, batch["labels"], num_classes, row_mask)
    return {"loss": loss, "confusion": cm, "preds": preds}
