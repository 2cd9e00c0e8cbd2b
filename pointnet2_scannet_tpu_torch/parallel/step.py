"""The data-parallel steps: the JAX package's parallel/step.py
make_shardmap_train_step (:194), make_shardmap_eval_step (:239) and
make_shardmap_accum_step (:469).

In the JAX package a shard_map runs the step on each device's rows of the
batch inside one program. Here each rank is a process that runs the eager
step of engine/train_state.py on its rows with the run's process group:
BatchNorm statistics through the model's bn_group, the loss as this rank's
share of the global loss, one all-reduce of the gradients after the
backward, loss and confusion summed. The model must be built with
bn_group=group (as the JAX step needs bn_axis_name=axis_name): without it
each rank would normalise over its own rows alone. With group None each
function returns the single-device step.
"""

from __future__ import annotations

import functools

from pointnet2_scannet_tpu_torch.engine import train_state as ts


def _check(model, group) -> None:
    if getattr(model, "bn_group", None) is not group:
        raise ValueError("a data-parallel step needs the model built with bn_group=<the run's "
                         "process group>, and a single-device step one built without")


def make_shardmap_train_step(model, group, *, num_classes: int):
    """fn(state, batch) -> {"loss", "confusion"}, over the global batch."""
    _check(model, group)
    return functools.partial(ts.train_step, num_classes=num_classes, group=group)


def make_shardmap_eval_step(model, group, *, num_classes: int):
    """fn(model, batch) -> {"loss", "confusion"} over the global batch and
    this rank's "preds"."""
    _check(model, group)
    return functools.partial(ts.eval_step, num_classes=num_classes, group=group)


def make_shardmap_accum_step(model, group, *, num_classes: int):
    """(accumulate, apply): accumulate(state, batch) is grad_accum_step on
    this rank's rows of a micro-batch (statistics through the model's
    bn_group, sums local); apply(state, total_count) sums the accumulated
    gradients over the ranks once and takes the optimizer step over the
    global count. One all-reduce a scene in place of one a micro-batch:
    the sums are the same."""
    _check(model, group)
    return (functools.partial(ts.grad_accum_step, num_classes=num_classes),
            functools.partial(ts.apply_accumulated, group=group))
