"""Train state and the train / eval steps, the JAX package's
engine/train_state.py.

The recipe: Adam (b1 0.9, b2 0.999, eps 1e-8) with torch-style coupled L2
weight decay, its learning rate on a staircase that decays by decay_factor
every decay_step epochs (counted in optimizer steps), the class-weighted
cross-entropy of engine/loss.py, flax-convention BatchNorm (models/layers.py)
and the confusion matrix counted on the batch's device. PyTorch runs the step
eagerly; there is no compiled step to build, so TrainState holds the model
and optimizer themselves.

Whole-scene training takes one optimizer step per scene: grad_accum_step per
micro-batch of the scene's columns, then apply_accumulated. With the
device-resident scene store, resident_train_step assembles its batch on the
device first.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from pointnet2_scannet_tpu_torch.data.resident import materialize_batch
from pointnet2_scannet_tpu_torch.engine.loss import softmax_ce_integer, weighted_cross_entropy
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
    _set_lr(state)
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


def resident_train_step(state: TrainState, store: dict, batch: dict[str, torch.Tensor], *,
                        num_classes: int) -> dict:
    """train_step on the batch that data/resident.materialize_batch gathers
    from the device-resident store (the JAX package's
    make_resident_train_step); the store is only read."""
    return train_step(state, materialize_batch(store, batch), num_classes=num_classes)


def grad_accum_step(state: TrainState, batch: dict[str, torch.Tensor], *, num_classes: int) -> dict:
    """One micro-batch of a gradient-accumulated step (the JAX package's
    grad_accum_step, train_state.py:134-190): the gradient of the
    micro-batch's loss SUM, sum(ce * weights * row_mask), is added into each
    parameter's .grad in order, as the JAX caller adds its gradient trees;
    the train-mode forward passes the row_mask to every BatchNorm
    (MaskedBatchNorm), whose running statistics move once per micro-batch.
    Returns {"loss_sum", "count"
    (sum(row_mask) * points per row), "confusion" (masked)} as tensors on
    the batch's device; nothing waits for the host. The Dropout mask comes
    from state.generator's stream (the JAX package folds the step and the
    micro-batch index into its key: the draws cannot match)."""
    model = state.model
    model.train()
    labels, row_mask = batch["labels"], batch["row_mask"]
    logits = model(batch["points"], state.generator, row_mask)
    ce = softmax_ce_integer(logits, labels)
    loss_sum = (ce * batch["weights"] * row_mask[:, None]).sum()
    loss_sum.backward()
    with torch.no_grad():
        cm = confusion_matrix(logits.argmax(dim=-1), labels, num_classes, row_mask)
    return {"loss_sum": loss_sum.detach(), "count": row_mask.sum() * labels.shape[-1],
            "confusion": cm}


def apply_accumulated(state: TrainState, total_count: torch.Tensor | float) -> None:
    """One optimizer step from the accumulated sum-gradients, each divided by
    total_count (the gradient of the scene's mean loss), at the learning
    rate of this step on the schedule; then the gradients are cleared for
    the next scene (the JAX package's apply_accumulated)."""
    _set_lr(state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.grad.div_(total_count)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


def _set_lr(state: TrainState) -> None:
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr


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
