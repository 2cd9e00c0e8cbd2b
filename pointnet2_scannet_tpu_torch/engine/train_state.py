"""Train state and the train / eval steps, the JAX package's
engine/train_state.py.

The recipe: Adam (b1 0.9, b2 0.999, eps 1e-8) with torch-style coupled L2
weight decay, its learning rate on a staircase that decays by decay_factor
every decay_step epochs (counted in optimizer steps), the class-weighted
cross-entropy of engine/loss.py, flax-convention BatchNorm (models/layers.py)
and the confusion matrix counted on the batch's device. PyTorch runs the step
eagerly; there is no compiled step to build, so TrainState holds the model
and optimizer themselves.

On a card the optimizer is Adam with capturable=True and its learning rate
a device tensor that each step fills from the schedule: the step makes no
host synchronisation and reads nothing from host memory, so
parallel/step.make_fused_train_step can capture K of them in one CUDA graph
(which reads each step's rate from a buffer on the device instead), and the
eager steps do the same arithmetic as the graph's. On the CPU it is the
plain Adam with a Python-float rate.

Whole-scene training takes one optimizer step per scene: grad_accum_step per
micro-batch of the scene's columns, then apply_accumulated. With the
device-resident scene store, resident_train_step assembles its batch on the
device first.

group (the JAX steps' axis_name): a data-parallel run's process group. Each
rank runs the step on its rows of the global batch with a model built with
bn_group=group; the loss is each rank's share of the global loss
(engine/loss.weighted_cross_entropy_sharded) and the gradients are summed
over the ranks in one all-reduce after the backward, so every rank applies
the single-process gradient of the global batch. The JAX package's
shard_map step sums its gradients once more after differentiating through
a summed loss and so scales them by the device count (ROADMAP, latent
reference issues); the port does not. Loss, point counts and confusion
matrices come back summed over the ranks.

Under tensor parallelism (parallel/mesh.py) group is the dp group: the
model splits its channels over the tp ranks itself and returns whole
logits, so the loss, its backward and the confusion are computed alike on
the tp ranks of a dp index. A split leaf's gradient is this rank's slice of
the gradient and a whole leaf's the same on every tp rank, so every
gradient is summed over the dp group alone, and Adam, elementwise, runs on
the slices with nothing crossing ranks. With dp 1 group is None.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
import torch.distributed as dist

from pointnet2_scannet_tpu_torch.data.resident import materialize_batch
from pointnet2_scannet_tpu_torch.engine.loss import (
    softmax_ce_integer,
    weighted_cross_entropy,
    weighted_cross_entropy_sharded,
)
from pointnet2_scannet_tpu_torch.engine.metrics import confusion_matrix
from pointnet2_scannet_tpu_torch.parallel.distributed import all_reduce_grads


def make_lr_schedule(
    lr: float, decay_step_epochs: int, decay_factor: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """optimizer step -> learning rate: lr * decay_factor ** (step // T) with
    T = decay_step_epochs * steps_per_epoch (at least 1)."""
    transition = max(decay_step_epochs * steps_per_epoch, 1)
    return lambda step: lr * decay_factor ** (step // transition)


def make_optimizer(params, lr: float, weight_decay: float = 0.0, *,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam with coupled L2 weight decay (wd * param joins the gradient before
    the moments), which the JAX package writes as add_decayed_weights then
    adam. capturable (parameters on a card): torch's capturable Adam, its
    step counts and learning rate (a float32 tensor) on the parameters'
    device."""
    params = list(params)
    if capturable:
        lr = torch.full((), lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
                            capturable=capturable)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the learning-rate schedule, the Dropout
    generator and the number of optimizer steps taken. shardings: under
    tensor parallelism, which of the model's leaves hold this rank's slice
    (parallel/mesh.shard_train_state); None where every leaf is whole."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0
    shardings: dict[str, bool] | None = None


def create_train_state(
    model: torch.nn.Module,
    schedule: Callable[[int], float],
    *,
    weight_decay: float = 0.0,
    seed: int = 0,
) -> TrainState:
    """A state over `model`; the Dropout generator lives on the model's
    device and is seeded from `seed`; on a card the optimizer is capturable
    (the module docstring)."""
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=make_optimizer(model.parameters(), schedule(0), weight_decay,
                                 capturable=device.type == "cuda"),
        schedule=schedule,
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def train_step(state: TrainState, batch: dict[str, torch.Tensor], *, num_classes: int,
               group=None, lr: torch.Tensor | None = None) -> dict:
    """One optimizer step on a batch of "points", "labels", "weights" and an
    optional "row_mask". Returns {"loss", "confusion"} as tensors on the
    batch's device; nothing waits for the host. group: see the module
    docstring (train_state.py:78-135 with axis_name). lr: a device tensor
    holding this step's learning rate (a CUDA graph's, read when the graph
    replays); None takes state.schedule(state.step)."""
    model = state.model
    model.train()
    _set_lr(state, lr)
    row_mask = batch.get("row_mask")
    logits = model(batch["points"], state.generator)
    if group is None:
        loss = weighted_cross_entropy(logits, batch["labels"], batch["weights"], row_mask)
    else:
        loss = weighted_cross_entropy_sharded(logits, batch["labels"], batch["weights"], row_mask, group)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if group is not None:
        all_reduce_grads(model.parameters(), group)
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        cm = confusion_matrix(logits.argmax(dim=-1), batch["labels"], num_classes, row_mask)
    return sum_over_ranks({"loss": loss.detach(), "confusion": cm}, group)


def resident_train_step(state: TrainState, store: dict, batch: dict[str, torch.Tensor], *,
                        num_classes: int, group=None, lr: torch.Tensor | None = None) -> dict:
    """train_step on the batch that data/resident.materialize_batch gathers
    from the device-resident store (the JAX package's
    make_resident_train_step); the store is only read. In a data-parallel
    run the store is this rank's (its scene shard's rows) and so are the
    batch's rows: the gather is local."""
    return train_step(state, materialize_batch(store, batch), num_classes=num_classes, group=group, lr=lr)


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
    micro-batch index into its key: the draws cannot match).

    In a data-parallel run (a model built with bn_group) each rank runs this
    on its rows of the micro-batch and the MaskedBatchNorm statistics cover
    every rank's; the sums stay local here and are summed over the ranks
    once a scene, by the caller and by apply_accumulated (the JAX
    package's shard_map step sums them every micro-batch: the same sums)."""
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


def apply_accumulated(state: TrainState, total_count: torch.Tensor | float, group=None) -> None:
    """One optimizer step from the accumulated sum-gradients, each divided by
    total_count (the gradient of the scene's mean loss), at the learning
    rate of this step on the schedule; then the gradients are cleared for
    the next scene (the JAX package's apply_accumulated). group: the
    gradients are summed over its ranks first, and total_count must be the
    global count."""
    _set_lr(state)
    if group is not None:
        all_reduce_grads(state.model.parameters(), group)
    with torch.no_grad():
        for p in state.model.parameters():
            p.grad.div_(total_count)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


def _set_lr(state: TrainState, lr: torch.Tensor | None = None) -> None:
    """This step's learning rate into the optimizer: schedule(step), or the
    device tensor lr; a capturable optimizer's rate tensor is written in
    place (a fill, or a copy on the device), so a graph that captured it
    reads the new value."""
    value = state.schedule(state.step) if lr is None else lr
    for group in state.optimizer.param_groups:
        if not torch.is_tensor(group["lr"]):
            group["lr"] = value
        elif torch.is_tensor(value):
            group["lr"].copy_(value)
        else:
            group["lr"].fill_(value)


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: dict[str, torch.Tensor], *, num_classes: int,
              group=None) -> dict:
    """Forward with the running BatchNorm statistics and no Dropout. Returns
    {"loss", "confusion", "preds"} on the batch's device; with a group the
    loss and confusion are the global batch's and preds this rank's rows."""
    model.eval()
    row_mask = batch.get("row_mask")
    logits = model(batch["points"])
    if group is None:
        loss = weighted_cross_entropy(logits, batch["labels"], batch["weights"], row_mask)
    else:
        loss = weighted_cross_entropy_sharded(logits, batch["labels"], batch["weights"], row_mask, group)
    preds = logits.argmax(dim=-1)
    cm = confusion_matrix(preds, batch["labels"], num_classes, row_mask)
    return {**sum_over_ranks({"loss": loss, "confusion": cm}, group), "preds": preds}


def sum_over_ranks(out: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Each tensor of out summed over the ranks of group (None: as it is)."""
    if group is not None:
        for t in out.values():
            dist.all_reduce(t, group=group)
    return out
