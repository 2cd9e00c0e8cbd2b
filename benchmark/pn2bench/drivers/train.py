"""The training driver: the program's fused train step (K steps a CUDA
graph launch, parallel/step.make_fused_train_step as scripts/train_torch.py
runs it with --fused_steps K on the host path), fed pinned HostGroups.

Set-up builds the one train state, makes its weights from the seed, and
drives it through its first call: the capture and the first replay, on the
pool's first group in the window's order. That same state and step then run
the window. The window starts at a synchronise and ends at the synchronise
after the first call that returns past `seconds`; at most two calls are in
flight (the CLI's prefetch depth), so the host never runs far ahead of the
card and the window's end waits for little.

The check: the configuration's reference follows the first call's K steps
from the same weights, batches and Dropout seed; compared are the first
two steps' losses and the median and the worst leaf's change over the K
steps (check.train_numbers). Every step of the window has to end with a
finite loss (a step that does not is a failed one).

controls(ctx), after run: the readings the limits are set from beside the
program's, the reference put in the program's place computed in TF32 (the
control), on half of each batch (the mean taken over the rest) and with
one BatchNorm's bias left unmoved (calibrate.py and the control's test).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import numpy as np
import torch

from pn2bench import check, port, profile, traffic

FROZEN_LEAF = "sa_0.mlp_0.bn_0.bias"  # the planted one-leaf fault's leaf


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    """ctx: harness.Context. Returns the driver's measurements."""
    model_cfg, mix, seed, device = ctx.model, ctx.mix, ctx.seed, ctx.device
    ctx.phase("imports")
    pool = traffic.train_pool(mix, seed, model_cfg["num_classes"])
    ctx.phase("traffic")
    model = ctx.builder.build(model_cfg, device)
    params = port.make_params(model, seed)
    port.load_params(model, params)
    ctx.phase("model")
    recipe = dict(lr=mix["lr"], decay_step_epochs=mix["decay_step_epochs"], decay_factor=mix["decay_factor"],
                  steps_per_epoch=mix["scenes_per_epoch"] // mix["batch"], weight_decay=mix["weight_decay"])
    dropout_seed = (seed + 1) % 2**63
    state, fused = port.fused_train(model, dropout_seed=dropout_seed, num_classes=model_cfg["num_classes"],
                                    **recipe)
    groups = [port.host_group(g, pin=device.type == "cuda") for g in pool.groups]
    order = [int(i) for i in pool.order]
    k = len(pool.groups[0])
    b, n = mix["batch"], mix["npoints"]

    ctx.phase("host groups")
    first = fused(state, groups[order[0]])
    _sync(device)
    ctx.phase("first call (capture and replay)")
    seen = {"losses": first["loss"].detach().cpu().double().numpy(),
            "params": {name: p.detach().clone() for name, p in model.named_parameters()},
            "moments": {name: m.detach().clone() for name, m in port.adam_moments(state).items()}}

    cursor = 1  # the next group in the window's order; the first call took order[0]

    def calls(count: int | None, seconds: float | None, spans: bool):
        """Calls of the fused step over the cycled groups; returns (calls,
        their losses)."""
        nonlocal cursor
        span = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())
        inflight, losses, done = collections.deque(), [], 0
        start = time.perf_counter()
        while True:
            with span("bench:fused_call"):
                out = fused(state, groups[order[(cursor + done) % len(order)]])
            losses.append(out["loss"])
            done += 1
            if device.type == "cuda":
                inflight.append(torch.cuda.Event())
                inflight[-1].record()
                if len(inflight) > 2:
                    with span("bench:wait"):
                        inflight.popleft().synchronize()
            if (count is not None and done >= count) or (seconds is not None and
                                                         time.perf_counter() - start >= seconds):
                break
        _sync(device)
        cursor += done
        return done, losses

    _sync(device)
    ctx.window_started()
    t0 = time.perf_counter()
    done, losses = calls(None, ctx.seconds, False)
    window_s = time.perf_counter() - t0
    steps = done * k
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    out = {"kind": "train", "devices": [device], "window_s": window_s, "attempted": steps,
           "failed": int((~finite).sum()), "steps": steps, "batch": b, "npoints": n,
           "metrics": {"train_points_per_s": steps * b * n / window_s},
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    if ctx.trace:
        def window():
            with torch.profiler.record_function("bench:window"):
                calls(mix["trace_groups"], None, True)

        out["trace"] = profile.traced(window, mix["trace_groups"] * k)
        out["trace_calls"] = mix["trace_groups"]
        out["capture_launches"] = port.capture_launches(fused)

    del fused, state, model, groups, first, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.first = (pool.groups[order[0]], params, seen, recipe, dropout_seed)  # controls() reads it
    out["checks"] = check_first_group(ctx, *ctx.first)
    return out


def check_first_group(ctx, batches, params, seen, recipe, dropout_seed) -> dict:
    """The compared numbers of the program's first call against the
    reference over its batches."""
    return check.train_numbers(seen, reference_run(ctx, batches, params, recipe, dropout_seed), params, ctx.detail)


def controls(ctx) -> dict[str, dict]:
    """After run(ctx): each stand-in's compared numbers and its worst
    leaves against the float32 reference, as the program's are."""
    batches, params, _, recipe, dseed = ctx.first
    want = reference_run(ctx, batches, params, recipe, dseed)
    out = {}
    for name, kw in (("control", {"tf32": True}), ("half_batch", {"rows": ctx.mix["batch"] // 2}),
                     ("one_leaf", {"frozen": FROZEN_LEAF})):
        detail: dict = {}
        numbers = check.train_numbers(reference_run(ctx, batches, params, recipe, dseed, **kw), want, params, detail)
        out[name] = {**numbers, "worst": detail}
    return out


def reference_run(ctx, batches, params, recipe, dropout_seed, *, tf32=False, rows=None, frozen=None) -> dict:
    """The reference's K steps over the batches: {"losses", "params",
    "moments"}. tf32 / rows / frozen: the control, the half-batch fault and
    a leaf left unmoved, the reference put in the program's place."""
    ref = ctx.reference
    trainer = reference_trainer(ctx, params, recipe, dropout_seed)
    losses = []
    with ref.precision(tf32):
        for b in batches:
            losses.append(trainer.step(_to_device(_rows(b, rows), ctx.device)))
            if frozen is not None:
                trainer.p[frozen] = params[frozen].clone()
    return {"losses": np.array(losses), "params": trainer.p, "moments": trainer.m}


def reference_trainer(ctx, params, recipe, dropout_seed):
    transition = max(recipe["decay_step_epochs"] * recipe["steps_per_epoch"], 1)
    lr, df = recipe["lr"], recipe["decay_factor"]
    return ctx.reference.Trainer(ctx.model, params, lr_at=lambda step: lr * df ** (step // transition),
                                 weight_decay=recipe["weight_decay"],
                                 generator=torch.Generator(device=ctx.device).manual_seed(dropout_seed))


def _rows(batch: dict, rows: int | None) -> dict:
    return batch if rows is None else {k: v[:rows] for k, v in batch.items()}
