"""The data-parallel steps: the JAX package's parallel/step.py
make_shardmap_train_step (:194), make_shardmap_eval_step (:239) and
make_shardmap_accum_step (:469); the dp x tp steps, make_sharded_train_step
(:124) and make_sharded_eval_step (:137), with the accumulation step of
whole-scene training beside them; and the fused steps,
make_fused_train_step (:49) and make_resident_fused_train_step (:318).

In the JAX package a shard_map runs the step on each device's rows of the
batch inside one program. Here each rank is a process that runs the eager
step of engine/train_state.py on its rows with the run's process group:
BatchNorm statistics through the model's bn_group, the loss as this rank's
share of the global loss, one all-reduce of the gradients after the
backward, loss and confusion summed. The model must be built with
bn_group=group (as the JAX step needs bn_axis_name=axis_name): without it
each rank would normalise over its own rows alone. With group None each
function returns the single-device step.

The dp x tp steps (a rank on a parallel/mesh grid, its train state laid out
by mesh.shard_train_state) are the same eager steps over the grid's dp
group, on a model built with bn_group=<dp group> and tp_group=<tp group>:
the model runs its channel shards and gathers them (models/layers.py), so
the step around it is the data-parallel one. As the JAX "gspmd_dp_tp"
step, the math is the single-process step's on the global batch.

The fused steps run K train steps a call, the exact math of K calls of the
per-batch step (the JAX package's lax.scan of train_step). On a card, with
no group or an NCCL group, the K steps run as ONE CUDA graph launch: they
are captured once per (K, the batches' shapes and dtypes, the store), and
every later call copies its batches into the graph's input slots and
replays it. The capture follows PyTorch's rules: the K steps run once on a
side stream as a warm-up (which also makes the optimizer's state, the
cuBLAS workspace of that stream, the NCCL communicator's first use on it
and every kernel's shared-memory attribute, csrc/smem_limit.cuh, before the
capture), the train state is put back as it was, and the K steps are
captured on the same stream, the BatchNorm and gradient all-reduces with
them, into a memory pool of the graph's own that lives as long as the
FusedTrainStep. The Dropout generator is registered with the graph, so
every replay draws the masks the eager steps would draw, in their order.
Each step reads its learning rate from a (K,) buffer on the device that the
host fills from the schedule before each launch, so a staircase boundary
inside a group takes effect at its step. On the CPU, and under gloo (a gloo
collective cannot be captured; under tensor parallelism either group's
backend decides), the same function runs the K steps eagerly. Nothing falls back: a capture that fails raises.

Launch counting under a graph (ops/cuda launch_counts): a wrapper counts
where Python calls it. The warm-up's K steps launch and count; the capture
counts the K steps' launches that it records (K times an eager step's
counts, FusedTrainStep.captures); a replay runs no Python and counts
nothing. What a replay launches shows in a torch.profiler trace of it.

NCCL across two or more cards is unverified here: the one-card machine
runs an NCCL group of one rank only.
"""

from __future__ import annotations

import functools
import time

import torch
import torch.distributed as dist

from pointnet2_scannet_tpu_torch.data.pipeline import GroupLayout, HostGroup
from pointnet2_scannet_tpu_torch.engine import train_state as ts


def _check(model, group, tp_group=None) -> None:
    if getattr(model, "bn_group", None) is not group:
        raise ValueError("a data-parallel step needs the model built with bn_group=<the run's "
                         "process group>, and a single-device step one built without")
    if getattr(model, "tp_group", None) is not tp_group:
        raise ValueError("a tensor-parallel step needs the model built with tp_group=<the grid's tp "
                         "group>, and any other step one built without")


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


def make_sharded_train_step(model, ctx, *, num_classes: int):
    """The dp x tp train step of a rank of ctx's grid: fn(state, batch) ->
    {"loss", "confusion"} over the global batch, batch this dp rank's rows
    (the same on the tp ranks of its dp index). A ctx without a grid gives
    make_shardmap_train_step's step over ctx.group (None: one device)."""
    _check(model, ctx.dp_group, ctx.tp_group)
    return functools.partial(ts.train_step, num_classes=num_classes, group=ctx.dp_group)


def make_sharded_eval_step(model, ctx, *, num_classes: int):
    """The dp x tp eval step: {"loss", "confusion"} over the global batch and
    this dp rank's "preds"."""
    _check(model, ctx.dp_group, ctx.tp_group)
    return functools.partial(ts.eval_step, num_classes=num_classes, group=ctx.dp_group)


def make_sharded_accum_step(model, ctx, *, num_classes: int):
    """(accumulate, apply) of whole-scene training on the grid: those of
    make_shardmap_accum_step over the dp group."""
    _check(model, ctx.dp_group, ctx.tp_group)
    return (functools.partial(ts.grad_accum_step, num_classes=num_classes),
            functools.partial(ts.apply_accumulated, group=ctx.dp_group))


def fused_mode(device: torch.device, *groups) -> str:
    """How the fused steps run: "graph" (one CUDA graph launch a group) on a
    card where every group given is None or NCCL, else "eager" (the CPU,
    gloo). groups: the dp group, and under tensor parallelism the tp group."""
    if torch.device(device).type != "cuda":
        return "eager"
    if any(g is not None and dist.get_backend(g) != "nccl" for g in groups):
        return "eager"
    return "graph"


def make_fused_train_step(model, group, *, num_classes: int, log=None, tp_group=None) -> "FusedTrainStep":
    """fn(state, batches) -> {"loss" (K,), "confusion" (K, C, C)} on the
    device, the stats of K train steps in order; batches: a
    data/pipeline.HostGroup, or a dict of (K, ...)-stacked tensors (this
    rank's rows under a group). log: a print-like callable for the one line
    a capture writes (its time and its pool's size). tp_group: the grid's
    tp group under tensor parallelism (group is then its dp group)."""
    return FusedTrainStep(model, group, num_classes=num_classes, resident=False, log=log, tp_group=tp_group)


def make_resident_fused_train_step(model, group, *, num_classes: int, log=None,
                                   tp_group=None) -> "FusedTrainStep":
    """fn(state, store, batches) -> stats: make_fused_train_step over
    resident batches ("idx" (K, B, NP) store rows and, with augmentation,
    "rot", "trans", "scale"), each step gathering its batch from the
    device-resident store (data/resident.materialize_batch); the store
    must keep its tensors between calls (a graph reads them in place)."""
    return FusedTrainStep(model, group, num_classes=num_classes, resident=True, log=log, tp_group=tp_group)


class _Captured:
    """One captured group: the graph, its input slots (views of one flat
    device buffer laid out as the host groups are), the (K,) learning-rate
    buffer and the stats it writes."""

    def __init__(self, layout: GroupLayout, device: torch.device):
        self.layout = layout
        self.flat = torch.empty(layout.nbytes, dtype=torch.uint8, device=device)
        self.slots = layout.views(self.flat)
        self.lrs = torch.empty(layout.k, dtype=torch.float32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.losses = self.confusions = None


class FusedTrainStep:
    """K train steps a call (module docstring). mode: "graph" or "eager";
    captures: one dict per capture (k, seconds, pool_bytes, launches: the
    launch counts that the capture recorded)."""

    def __init__(self, model, group, *, num_classes: int, resident: bool, log=None, tp_group=None):
        _check(model, group, tp_group)
        self.group = group
        self.groups = [g for g in (group, tp_group) if g is not None]
        self.num_classes = num_classes
        self.resident = resident
        self.log = log
        self.device = next(model.parameters()).device
        self.mode = fused_mode(self.device, group, tp_group)
        self.captures: list[dict] = []
        self._graphs: dict = {}

    def describe(self, k: int) -> str:
        """The mode line of K steps a group."""
        if self.mode == "graph":
            return f"fused_steps {k}: one CUDA graph per {k} steps"
        why = dist.get_backend(self.groups[0]) if self.groups else self.device.type
        return f"fused_steps {k}: {k} eager steps per group ({why})"

    def __call__(self, state, *args) -> dict:
        store, batches = args if self.resident else (None, args[0])
        if self.mode == "eager":
            return self._eager(state, store, batches)
        return self._replay(state, store, batches)

    def _step(self, state, store, batch: dict, lr=None) -> dict:
        if self.resident:
            return ts.resident_train_step(state, store, batch, num_classes=self.num_classes,
                                          group=self.group, lr=lr)
        return ts.train_step(state, batch, num_classes=self.num_classes, group=self.group, lr=lr)

    def _eager(self, state, store, batches) -> dict:
        arrays = (batches.to(self.device) if isinstance(batches, HostGroup)
                  else {k: v.to(self.device) for k, v in batches.items()})
        k = next(iter(arrays.values())).shape[0]
        outs = [self._step(state, store, {n: a[i] for n, a in arrays.items()}) for i in range(k)]
        return {"loss": torch.stack([o["loss"] for o in outs]),
                "confusion": torch.stack([o["confusion"] for o in outs])}

    def _replay(self, state, store, batches) -> dict:
        layout = (batches.layout if isinstance(batches, HostGroup)
                  else GroupLayout.of({n: (tuple(a.shape), a.dtype) for n, a in batches.items()}))
        key = (layout, None if store is None else tuple(t.data_ptr() for t in store.values()))
        cap = self._graphs.get(key)
        fresh = cap is None
        if fresh:
            cap = _Captured(layout, self.device)
        self._load(cap, state, batches)
        if fresh:
            self._capture(cap, state, store)
            self._graphs[key] = cap
        cap.graph.replay()
        state.step += layout.k
        return {"loss": cap.losses.clone(), "confusion": cap.confusions.clone()}

    def _load(self, cap: _Captured, state, batches) -> None:
        """The group's batches into the slots and its K learning rates into
        the rate buffer: copies on the current stream, so ordered before the
        launch."""
        if isinstance(batches, HostGroup):
            cap.flat.copy_(batches.buffer, non_blocking=True)
        else:
            for name, a in batches.items():
                cap.slots[name].copy_(a, non_blocking=True)
        lrs = torch.tensor([state.schedule(state.step + i) for i in range(cap.layout.k)], dtype=torch.float32)
        cap.lrs.copy_(lrs.pin_memory(), non_blocking=True)

    def _body(self, cap: _Captured, state, store) -> list[dict]:
        return [self._step(state, store, {n: s[i] for n, s in cap.slots.items()}, lr=cap.lrs[i])
                for i in range(cap.layout.k)]

    def _capture(self, cap: _Captured, state, store) -> None:
        """Warm up, restore, capture (module docstring)."""
        from pointnet2_scannet_tpu_torch.ops import cuda as kernels

        k, device = cap.layout.k, self.device
        t0 = time.perf_counter()
        saved = _snapshot(state)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            outs = self._body(cap, state, store)
            cap.losses = torch.empty((k,) + outs[0]["loss"].shape, dtype=outs[0]["loss"].dtype, device=device)
            cap.confusions = torch.empty((k,) + outs[0]["confusion"].shape, dtype=outs[0]["confusion"].dtype,
                                         device=device)
        torch.cuda.current_stream(device).wait_stream(stream)
        del outs
        _restore(state, saved)
        cap.graph.register_generator_state(state.generator)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # as the capture does first: what it reserves then is its pool
        reserved = torch.cuda.memory_reserved(device)
        before = kernels.launch_counts()
        free, total = torch.cuda.mem_get_info(device)
        try:
            # thread_local: the prefetch thread may pin host memory meanwhile
            with torch.cuda.graph(cap.graph, stream=stream, capture_error_mode="thread_local"):
                for i, out in enumerate(self._body(cap, state, store)):
                    cap.losses[i].copy_(out["loss"])
                    cap.confusions[i].copy_(out["confusion"])
        except Exception as e:
            if _out_of_memory(e):
                raise RuntimeError(
                    f"fused_steps {k}: the CUDA graph of {k} train steps does not fit on {device} "
                    f"({free / 2**20:.0f} MiB free of {total / 2**20:.0f} MiB before the capture); "
                    "take a smaller --fused_steps") from e
            raise
        finally:
            state.step = saved["step"]  # the capture ran no step; its Python counted K
        after = kernels.launch_counts()
        info = {"k": k, "seconds": time.perf_counter() - t0,
                "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
                "launches": {n: after[n] - before[n] for n in after}}
        self.captures.append(info)
        if self.log is not None:
            self.log(f"fused_steps {k}: captured {k} train steps as one CUDA graph in {info['seconds']:.2f} s "
                     f"(warm-up included), its memory pool {info['pool_bytes'] / 2**20:.1f} MiB", flush=True)


def _out_of_memory(e: BaseException | None) -> bool:
    """Whether e, or an exception it arose from, is a CUDA out-of-memory."""
    while e is not None:
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        e = e.__cause__ or e.__context__
    return False


def _snapshot(state) -> dict:
    """What a train step changes: the parameters, the buffers (BatchNorm
    statistics), the optimizer's tensors and learning rates, the Dropout
    generator and the step count."""
    opt = state.optimizer
    params = list(state.model.parameters())
    return {
        "params": [p.detach().clone() for p in params],
        "buffers": [b.clone() for b in state.model.buffers()],
        "optimizer": {p: {n: v.clone() for n, v in opt.state[p].items() if torch.is_tensor(v)}
                      for p in params if opt.state.get(p)},
        "lr": [g["lr"].clone() if torch.is_tensor(g["lr"]) else g["lr"] for g in opt.param_groups],
        "generator": state.generator.get_state(),
        "step": state.step,
    }


@torch.no_grad()
def _restore(state, saved: dict) -> None:
    """Put state back as _snapshot found it, in place (the same tensors, so
    a capture that follows reads them); optimizer state that the warm-up
    created is zeroed, as a fresh Adam state is."""
    opt = state.optimizer
    params = list(state.model.parameters())
    for p, v in zip(params, saved["params"]):
        p.copy_(v)
        p.grad = None
    for b, v in zip(state.model.buffers(), saved["buffers"]):
        b.copy_(v)
    for p in params:
        had = saved["optimizer"].get(p)
        for n, v in opt.state.get(p, {}).items():
            if torch.is_tensor(v):
                v.copy_(had[n]) if had is not None else v.zero_()
    for g, lr in zip(opt.param_groups, saved["lr"]):
        if torch.is_tensor(g["lr"]):
            g["lr"].copy_(lr)
    state.generator.set_state(saved["generator"])
    state.step = saved["step"]
