#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (pointnet2_scannet_tpu_torch) once on one GPU.

    python3 chip_smoke.py

1. The card: torch's device name and nvidia-smi's name and power limit.
2. Build the CUDA kernels from csrc/ (nvcc, sm_90a) and time the build.
3. Each forward kernel against its plain PyTorch version on the card at the
   SSG serving path's shapes (32 columns of 8192 points, the four levels;
   the gather at the centroids, the groupings and FP0-FP3's interpolation):
   indices and gathers must be equal bit for bit; both times from CUDA events
   after a warm-up, beside torch.gather's for each gather and the plan of
   FPS, the ball query and 3-NN for each level; the gather summed over
   SSG's 8 gathers, its 12, MSG's 16.
4. The scatter-add (every gather's backward) at the seven shapes of the SSG
   train step, its indices the ball-query and 3-NN outputs of phase 3: equal
   bit for bit to the plain version run on CPU copies, and to itself across
   two launches; timed with the route its plan takes, beside scatter_add_
   and the bound. Then the same at 65535 outputs a row, one of them named
   about 1000 times (B 2, J 131072, C 64: the card-wide sort's route).
5. The two-radius ball query of the MSG levels against its plain version at
   the four MSG levels (the same level clouds), bit for bit, timed beside
   two single-radius launches per level, each level with its plan.
6. The gather at the MSG model's grouping and interpolation widths, and the
   scatter-add at its train step's backward shapes, both listed from the MSG
   model (its pregather gate picks which gathers a level makes): the checks
   of phases 3 and 4.
7. The MSG model with its pregather gate as it stands (on at SA3, SA4) and
   forced off: eval logits must agree; the serving forward and the train
   step at batch 32 x 8192 timed side by side. One forward under the
   MXU-gather configuration (P1, below) must launch e and give the default
   configuration's logits bit for bit.
8. The kernels that a switch or a shape selects, each bit for bit against
   its plain version and timed beside it, beside its older counterpart and
   the library call: the shared-memory gather (e) at every gather the SSG
   model takes through the MXU route (the MXU-gather configuration, P1) and
   at scripts/bench_gather.py's shapes (B 32, N 8192, J 32768, C 9/32/64);
   the shared-memory scatter-add (f) at P1's train-step backwards and at
   those shapes, also against itself across two launches; the split gather
   (g, e's kernel through its own wrapper) at those shapes; the query-major
   3-NN (j) at FP0 of 7936-point columns and at n = m = 8192; the fused
   gather-matmul (k) at scripts/bench_fused_sa.py's shape (B 32, N 8192,
   J 32768, C 9, F 32), beside the unfused composition it replaces (d, then
   torch.matmul) and its own general route (w in shared memory), with the
   device time of both routes from torch.profiler.
9. Serve synthetic scenes through scripts/infer_torch.py, the SSG model then
   the MSG model, at full width (xyz + color + normal, 8192-point columns,
   batch 32, float32) with weights drawn from a seeded generator: the
   prediction files must hold labels in [0, 20), every forward kernel of the
   model's path must have moved its launch counter in that run (and no
   other), the logits of a batch of CHECK_COLUMNS columns must agree with
   the plain path on the CPU, and the steady batch of 32 is timed.
10. Train through scripts/train_torch.py at the same width, SSG then MSG
    (--use_msg): 32 synthetic scenes, batch 32, 3 epochs of one step and one
    validation each. Losses must be finite, the run dir's artifacts must
    exist, and every kernel of the path must have moved its counter in that
    run.
11. For SSG then MSG: one train step on the card against one on the CPU (2
    full-width columns, Dropout off): loss, gradients and BatchNorm
    statistics within the stated bounds; two train steps on the card from
    one state and batch must give the same bits; the steady-state train
    step at batch 32 x 8192 (forward, loss, backward, Adam, confusion
    matrix), timed with CUDA events, and its peak device memory.
12. P1, the SSG model under the MXU-gather configuration
    (ops_config.vmem_gather = False, mxu_gather = True, set in process and
    restored after): phases 9 to 11 again, with e and f on the path; then
    the steady serving forward and train step timed beside the default
    configuration's, in the order default, P1, P1, default.
13. P2, the SSG model at chunk sizes that are not 8192 under the default
    configuration: train 3 steps and serve at 8000 points (not a multiple of
    128: FP0 routes to XLA's top-k in the JAX package, so to three_nn.cu
    here) and at 7936 (a multiple of 256 that the known-major kernel's
    512-query tile does not divide: FP0 routes to j, once per forward).
14. scripts/bench_gather_torch.py, g's entry point, at its shapes: every
    forward equal to torch.gather's, the ordered backwards equal.
15. scripts/bench_fused_sa_torch.py, k's entry point, at its shape: the
    fused and unfused results within 1e-5 of a float64 reference.
16. Whole-scene training through scripts/train_torch.py --use_wholescene,
    SSG then MSG, at full width: 4 synthetic scenes of ~25 columns,
    micro-batches of 16 (so each scene's last one is padded), 2 epochs of
    one update per scene and one whole-scene validation. Losses must be
    finite and the run dir's artifacts must exist.
17. For SSG then MSG: one scene's accumulated update (3 full-width
    columns at micro-batch 2: two micro-batches, one padded row, Dropout
    off) on the card against the CPU: loss sum, point count and BatchNorm
    statistics within phase 11's bounds, the accumulated gradients held
    against a float64 CPU update as in phase 11; FPS, the ball query (the
    two-radius one for MSG) and 3-NN on the padded micro-batch's level
    clouds bit for bit against their plain versions. Then the steady
    whole-scene update of one synthetic scene at micro-batch 32, timed with
    CUDA events.
18. P3, the SSG model at 32768-point columns, batch 8 (the 32768-point
    chunk recipe), float32, full width: FPS against its plain version bit
    for bit at (8, 32768) -> 1024, (8, 20000) -> 1024 and -> 2048
    (VoteNet's SA1) in float32, (2, 32768) -> 1024 in float64 and at the
    cluster kernel's limits, (1, 131072) float32 and (1, 65536) float64 ->
    128, with points at the origin and exact ties (a cluster of blocks a
    row), each with its µs a step and plan; the ball query (its tiled route) at
    (8, 32768) -> 1024 and 3-NN at (8, 32768, 1024) on P3's columns, bit for
    bit against their plain versions and timed; train 3 steps through
    scripts/train_torch.py and serve through scripts/infer_torch.py, each
    launching the kernels of its path and FPS's cluster variant once a
    forward (SA1); one train step card vs CPU at 2 x 32768 under phase 11's
    bounds; the steady 8 x 32768 train step, timed.
19. bench_torch.py's cells (bench_torch.run("cuda")), its JSON line printed:
    the SSG and MSG train steps (float32 and bfloat16), serving batches and
    whole-scene updates,
    P3's step, the eval scenes/s and the Solver cells (host path and device
    store); every number finite and positive, and
    the default route's kernels launched (FPS, both ball queries, the
    gather, 3-NN, the scatter-add) and no other.
20. A short SSG run of scripts/train_torch.py (phase 10's) under --trace:
    one trace file, whose kernel events name FPS and the other hand-written
    kernels of the step.
21. Whole-scene evaluation, SSG then MSG, at full width with weights drawn
    from a seeded generator: scripts/eval_torch.py and
    scripts/visualize_torch.py on 4 synthetic scenes at batch 32, each
    launching every forward kernel of the model's path (the ring gathers
    included) and no other; the report finite with every metric in [0, 1],
    eval_report.txt and one PLY a scene written; the steady evaluation timed
    (scenes/s, and per scene the tiling ms, the forward's device ms from
    CUDA events and the metrics ms); each scene's labels equal bit for bit
    to the argmax of Predictor's batches of 32 over the same column stacks,
    and scene 0's equal to the CPU evaluator's at >= 0.999 of the points.
22. The device-resident scene store: scripts/train_torch.py --device_store
    (phase 10's SSG run: 32 scenes, batch 32, 3 epochs) with no "device_store
    disabled" line, its losses finite, launching every kernel of phase 10's
    run as often and d (the store gather) twice more a step; the chunked
    Solver from one seed on the host path and with device_store (32
    fast_scene scenes of 100 000 points, batch 32 x 8192, 2 epochs,
    augmentation off): per-step losses equal bit for bit, d twice more a
    step; and d's store gather (two launches: points, labels) at the
    bench_torch.py Solver cell's store (256 scenes, T = 25.6 M rows) on one
    resident batch's rows, bit for bit against gather_plain, timed beside
    torch.index_select and the bound.
23. The bfloat16 compute dtype. d on bfloat16 rows at every gather of the
    SSG and MSG bfloat16 train steps (the packed [xyz_hi | xyz_lo |
    features] payloads, 6 + C wide, and the FP interpolations) and at SA1's
    odd payload of a 3-channel input (6 + 3), bit for bit against
    gather_plain; h on bfloat16 cotangents at those train steps' gather
    gradients and at phase 4's skewed row, bit for bit against the plain
    version (float32 sums rounded once) on CPU copies; both timed beside
    the library call (torch.gather; scatter_add_ on float32 copies) and the
    bound (these run with phases 3-8). Then for SSG and MSG: a bfloat16 run
    dir served through scripts/infer_torch.py (logits within 4% of the
    largest, labels equal at 99% of the points counting bfloat16 ties,
    card against CPU); scripts/train_torch.py --bf16 (phase 10's run) and
    scripts/eval_torch.py on its run dir, each launching the kernels of its
    path (a, b or c, d, h in training, i) and no other, d and h on
    bfloat16 rows; one bfloat16 train step card vs CPU (loss within 2e-3,
    gradients at most 1.25 times as far from a float64 CPU step as the
    CPU's bfloat16 ones, and at the median tensor no further from the CPU's
    bfloat16 gradients than those are from the float64 step; the same
    gates refuse the card's step with h's output halved and zeroed); two
    bfloat16 steps on the card bit-identical, and the
    steady step timed. Phase 19's bench_torch.py row carries the bfloat16
    fields.
24. bfloat16 under P1 (the MXU-gather configuration). e on bfloat16 rows
    at every gather that the SSG and MSG bfloat16 train steps route to it
    under P1 (the packed SA1-SA3 groupings) and at bench_gather's shapes (C
    9, the 2-byte route, 32, 64), bit for bit against gather_smem_plain; g
    on bfloat16 rows at those shapes; f on bfloat16 cotangents at those
    train steps' backwards, at bench_gather's shapes and at phase 4's skewed
    row, bit for bit against its plain version's bfloat16 branch (the TPU
    kernel's order: a float32 sum a 128-index tile, rounded, added to a
    bfloat16 accumulator) on CPU copies and against a second launch; each
    timed beside its counterpart (d, h, d), the library call (torch.gather;
    scatter_add_ on float32 copies, which rounds once and so computes
    another function) and the bound (these run with phases 3-8). Then the
    SSG bfloat16 model under P1 through the entry points: a bfloat16 run
    dir served through scripts/infer_torch.py (phase 23's serving gates,
    card against CPU), scripts/train_torch.py --bf16 (phase 10's run) and
    scripts/eval_torch.py on its run dir, each launching its path's kernels
    (e, and f in training, on bfloat16 rows; d and h at SA4 and the FP
    levels) and no other; one bfloat16 train step card vs CPU under phase
    23's gates, which must refuse the card's step with f's output halved
    and zeroed; two steps bit-identical; the steady step and serving batch
    timed beside the default configuration's bfloat16 ones and P1's float32
    ones, in the order default, P1, P1, default. The MSG bfloat16 model
    under P1: one serving forward card vs CPU under phase 23's logit and
    label gates (e launched on bfloat16 rows) and one train step card vs
    CPU under the same gates.
25. The serving artifacts (torch.export, the kernels as pn2:: ops). For the
    SSG and MSG float32 run dirs of phase 9 and phase 23's SSG bfloat16
    one (made anew from the same seed): scripts/infer_torch.py serving the
    run dir, then --export --platforms cuda and --from_artifact of that
    artifact, 4 synthetic scenes each: the artifact's prediction and PLY
    files equal the run dir's byte for byte, its run launches its route's
    kernels and no other (the export none). One SSG artifact traced on the
    CPU (--platforms cpu cuda, 8 x 8192) and served on the card: labels
    equal to Predictor's bit for bit, every 3-NN on three_nn (the CPU's
    route). Each artifact's export seconds, graph nodes and MB, and its
    steady batch of 32 x 8192 beside Predictor's (median of 9, in turns).
26. Multiview and the mv131 recipe (xyz + normal + 128-d ENet features,
    131 input channels). ENet (float32, eval, 8 frames of 256 x 328) on the
    card against the CPU from the same seeded weights within rtol 1e-3,
    atol 1e-4, and scripts/bench_enet_torch.py's frames/s (float32,
    bfloat16); the correspondence of one synthetic scene of 100 000 points
    seen by 16 cameras, card against CPU (differing pairs counted, at most
    1e-5 of them, each within 1e-4 of a decision threshold); the multiview
    CLI's loop body (scripts/multiview_torch.process_frames: ENet,
    correspondence and fusion on the card) equal bit for bit to
    fuse_scene_features on the CPU over the card's features and
    correspondences. Then the SSG mv131 model trained by the Solver (32
    scenes written as .npy, read back with the features in memory, so the
    phase needs no h5py; scene 0 with the fused features, the others
    label-correlated; 3 steps of 32 x 8192) and its run dir evaluated, each
    launching a, b, d, h (training) and i and no other, SA1 taking the
    pregather in every forward and no other level (the gathers of SA1's
    pregather and their scatter-add are checked with phases 3 and 4, at
    B 32 x 8192 x 32 and x 3 through the 32768-row index); the mv131 train step
    card vs CPU under phase 11's gates, determinism and its steady time;
    SA1's pregather against the unfused composition (SA1's forward, the
    serving forward, the train step).
27. Data parallelism (parallel/, one rank a device). (a) One NCCL rank:
    the data-parallel SSG train step at 32 x 8192 x 9 (Dropout 0.5) equal
    bit for bit to the plain single-process step (loss, gradients, BatchNorm
    statistics, parameters), launching the kernels of the path. (b) Two
    gloo ranks sharing cuda:0, 16 columns each: two SSG train steps
    (Dropout off) against the single-process step at batch 32 on the card
    (the second from the ranks' state after the first), each step's loss and BatchNorm statistics within phase 11's bounds and
    its gradients (before the optimizer) within twice phase 11's bound of
    the single-process step's (2 x TRAIN_GRAD_VS_CPU times the CPU's float32
    gradients' distance from its float64 step: both within phase 11's bound
    of the float64 gradient), over all parameters and at the median tensor
    (as phase 23 holds bfloat16 gradients); the gradient doubled
    must fail that bound (the JAX shard_map step's scale); then one
    whole-scene accumulated update (20 columns in micro-batches of 16, rank
    1's rows of the padded one all padding) under the same gates. Each step's
    time on both ranks, and the share of it spent in the all-reduces (the
    step timed again with every all-reduce a no-op). (c) On the same two
    ranks, phase 10's SSG run through train_torch.train (32 scenes, batch
    32, 2 epochs): finite losses, rank 0 alone writes a run dir, and every
    kernel of the path launched on both ranks. (d) eval_torch.py's and
    visualize_torch.py's entry points on the same ranks over 4 synthetic
    scenes: the merged report equal to the single-process report on the
    card, and one PLY a scene. NCCL across two or more cards is not run
    here (one card).
28. The fused steps (parallel/step.make_fused_train_step: FUSED_K train
    steps as one CUDA graph launch). (a) SSG float32 at 32 x 8192, Dropout
    0.5: from one seeded state, one launch and 8 eager steps over the same
    batches agree bit for bit (8 losses, 8 confusions, every parameter and
    BatchNorm statistic, Adam's moments and step counts, the Dropout
    generator), twice (the capturing call, then a plain replay); the capture
    counts 8 times an eager step's launches; a torch.profiler trace of the
    replay names the path's hand-written kernels (a, b, d, h, i) and no
    other, none more often than the capture counted (fewer only where the
    profiler dropped events, which the line reports). (b) The same for MSG (c in
    place of b), SSG bfloat16 (d and h on bfloat16 rows) and the
    device-resident store (d on store rows, with augmentation). (c) ms a
    step, eager against the graph, median (min, max) of 3 windows of 24
    steps; the capture's time and its pool's MiB. (d) One NCCL rank: (a)'s
    gates with the BatchNorm and gradient all-reduces captured in the graph,
    and (c)'s timing over windows of 8 steps. (e) Two gloo ranks sharing the
    card, each training from its own scene shard's device store with
    --fused_steps 8 (eager under gloo): no WARNING, the eager mode line,
    losses equal bit for bit to the data-parallel host path's. (f) Phase 10's SSG run through
    train_torch.py at batch 4 (an epoch one group of 8) with --fused_steps
    8, then a resume: the mode line and the capture line in both.
29. The shape families (engine/shape_runs.py), cls and partseg, SSG and
    MSG, at their published recipes (1024 points; cls batch 32, partseg
    batch 16; 8 classes or categories). FPS, the ball query (three radii
    take three launches), the two-radius query (partseg MSG's SA2) and 3-NN
    (partseg's FP1, FP2) on the families' level clouds, bit for bit against
    their plain versions, timed beside their bounds; the gather at the SSG
    forwards' gathers and the scatter-add at their backwards, as phases 3
    and 4 check them. For each variant:
    scripts/train_cls_torch.py or train_partseg_torch.py, 2 epochs of 3
    batches and 1 validation batch, launching exactly its path's kernels (a
    twice a forward; b, c and i as the spec's levels take them; d; h in
    training) and no other, its losses finite; scripts/eval_shapes_torch.py
    on the run, every metric in [0, 1], forward kernels only;
    scripts/infer_torch.py --export of the run, the artifact's labels on
    the card equal to Predictor's bit for bit; the steady train step's ms
    and samples/s. One train step card vs CPU (float64 reference) for cls
    SSG (8 clouds) and partseg MSG (1 cloud, SA2 on the pregather) under
    phase 11's bounds, the gradients over all parameters and at the median
    tensor (a BatchNorm bias whose shift the next train-mode BatchNorm
    removes has a zero gradient), the CPU's float32 distance floored at
    SHAPE_GRAD_FLOOR. A --bf16 cls SSG run of 2 steps: finite
    losses, d and h on bfloat16 rows.
30. The votenet modules (SetAbstractionVotes, SetAbstractionMSGVotes,
    LearnableFeaturePropagationMSG) at VoteNet's widths on 8 synthetic
    scenes of 20 000 points with a height channel: its backbone's four SA
    levels and its proposal SA on SA2's 1024 seeds of 256 channels, and the
    JAX msg_spec's SA1 and SA2 as SetAbstractionMSGVotes with an LFP from
    SA2 back onto SA1. FPS, the single- and two-radius ball queries, the
    gather and the scatter-add at those shapes, bit for bit against their
    plain versions and timed beside their bounds; one train-mode forward
    and backward launching exactly its kernels, finite; the steady train
    forward, forward and backward, and eval forward; one step of 2 scenes
    card vs CPU under phase 29's gates (float64 reference). Then
    scripts/preprocess_torch.py on a synthetic raw scan of 100 000 mesh
    vertices on the card and with --device cpu (equal but the normals,
    within 1e-6), and virtual_scan of that scene (modes -1, 2, 4), the
    card's indices equal to the CPU's.
31. Tensor parallelism (parallel/mesh.py, the JAX "gspmd_dp_tp" strategy) on
    a dp 1 x tp 2 grid of two gloo ranks sharing cuda:0, SSG and MSG at 20
    classes, 9 channels, TP_BATCH columns of 8192 points, float32, Dropout
    off, both ranks on every column. (a) One train step from the full
    weights against the single-process step on the card (phase 27 (b)'s
    gates: loss and BatchNorm statistics within phase 11's bounds, the
    gradients gathered from the shards within DP_GRAD_BOUND times phase
    11's float32 noise of the model, the doubled gradient refused), and the
    updated state gathered whole equal on both ranks. (b) Each rank holds
    its slice of every split leaf, the Adam moments with them: numel
    against the whole state's. (c) Each rank's step launches the path's
    kernels exactly as often as the single-process step (a, b, d, h, i; c
    in b's place for MSG) and no other, each launch bit for bit against its
    plain version on the same inputs (the scatter-add's on CPU copies).
    (d) phase 10's SSG run through train_torch.train with --tp 2 on the two
    ranks (32 scenes, batch 32, 2 epochs): finite losses, the path's
    kernels on both ranks, model_last the whole state: restored onto the
    grid it gathers back equal, a tp-1 eval_torch.evaluate on the card reads
    it, and a --resume at --tp 2 trains a third epoch. (e) The steady SSG
    step of the two ranks beside the single-process step (host clock), and
    the share of it in the tp collectives (a run with each collective
    timed between synchronisations). NCCL across cards is not run here.
32. The op-lowering switches (ops/tuning.py). (a) dense, cached and fast
    interpolation at SSG's four FP shapes (B 32), float32 and bfloat16:
    the forward and the points' gradient against the same function on the
    CPU (its first INTERP_CPU_ROWS rows; float32 within 1e-5 of the
    largest |value|, bfloat16 2 ulps of it) and, in float32, against the
    gather form on the card; fast launches one d a forward and no h, dense
    and cached neither; each form's forward-and-backward ms beside the
    gather form's. (b) h's card-wide sort route (scatter_add_sorted_cuda)
    at SSG's SA2-SA4 grouping backwards, float32 and bfloat16, bit for bit
    against its plain version, timed beside the block route; one SSG train
    step at 32 x 8192 under group_segsum, float32 and bfloat16, bit-equal
    to the default step (loss, gradients, parameters, BatchNorm
    statistics), with exactly 3 sort-route and 4 block-route launches of h
    (the default: 7 block); a CUDA graph of 2 such steps bit-equal to 2
    eager ones; the step's ms beside the default's. (c) fps_pallas and
    ball_query_pallas False: an SSG serve batch's logits bit-equal to the
    default's, the same launches, "xla" routes; interpolate_dense: logits
    within 1e-4, a train step against the CPU under phase 11's gates with
    the same switch, and the step's ms beside the default's. (d) pregather_dense True pregathers every SA
    level of the 9-channel SSG, False turns mv131's SA1 pregather off,
    logits within 1e-4. (e) scripts/bench_fp_torch.py (float32) and
    scripts/bench_pregather_torch.py --quick, each printing its JSON line.
33. Print one JSON line of kernel results (time, plain time, the card's bound
    for the same work, the time of one PyTorch library call where one
    computes the same function, the older counterpart's time where there is
    one; e, f and g on bfloat16 rows in rows of their own), the card line,
    and last {"ok": true, "device": {...}}.

The steady train steps (phases 11, 12, 18) and whole-scene updates (phase
17) are timed by bench_torch.py's functions. Each run of phases 9, 10, 12,
13, 14, 15, 16, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31 and 32 starts with every launch counter at 0 and
must launch every kernel of its path and no other. Any
failure raises and exits non-zero; so does a run without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import pathlib
import sys
import tempfile
import time

import bench_torch

ROOT = pathlib.Path(__file__).resolve().parent
BATCH = 32
NPOINTS = 8192
NSAMPLE = 32
KINDS = ("ssg", "msg")
# (points in, points out, radius, channels grouped beside xyz) per SSG level
LEVELS = ((8192, 1024, 0.1, 6), (1024, 256, 0.2, 64), (256, 64, 0.4, 128), (64, 16, 0.8, 256))
# logits of the card vs the CPU: f32 matmuls sum in another order in cuBLAS
# and in the CPU BLAS; every index the ops produce is identical
LOGIT_RTOL = LOGIT_ATOL = 1e-4
# channels of the features each SSG FP level interpolates (FP0 .. FP3)
FP_CHANNELS = (128, 256, 256, 512)
# one train step, card vs CPU: f32 summation order is the only difference.
# Loss and BatchNorm statistics are held to fixed bounds. The gradients are
# held against a float64 step on the CPU: the card's float32 gradients may be
# at most TRAIN_GRAD_VS_CPU times as far from it (per-tensor relative L2,
# worst and median tensor) as the CPU's float32 gradients are. A fixed bound
# does not hold: the train-mode BatchNorm backward below the head
# (dy - mean(dy) - x_hat * mean(dy * x_hat)) cancels most of dy, which
# magnifies float32 rounding to ~1e-3 relative on the CPU alone.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_VS_CPU = 2.0
TRAIN_BN_TOL = 1e-4
# the card's bound for a kernel's work (one NVIDIA H100 SXM, published peaks
# at 700 W): bytes over the memory rate, float32 operations outside the
# tensor cores over their peak rate. Operations counted per kernel: FPS 10
# per point and step (d^2 8, running min 1, argmax compare 1); ball query 9
# per point a query's scan reads up to its k-th hit (d^2 8, 1 compare), the
# two-radius one 10 (2 compares) over the longer of its two scans; either
# 3-NN 9 per pair; either scatter-add 1 per added word; every gather none;
# the fused gather-matmul 2 per weight and output row (C x F multiply-adds).
# Bytes: each input read once, each output written once; of a gather's
# source, the distinct rows its indices name in this run.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the MXU-gather configuration (P1); P2's chunk sizes; bench_gather's shapes
MXU_CONFIG = {"vmem_gather": False, "mxu_gather": True}
P2_NPOINTS = (8000, 7936)
# P3: the 32768-point chunk recipe; FPS's (batch, points, dtype, centroids)
# checks there, VoteNet's SA1 and the cluster kernel's limits
P3_BATCH, P3_NPOINTS, P3_CENTROIDS = 8, 32768, 1024
P3_FPS = ((8, 32768, "float32", 1024), (8, 20000, "float32", 1024), (8, 20000, "float32", 2048),
          (2, 32768, "float64", 1024), (1, 131072, "float32", 128), (1, 65536, "float64", 128))
BENCH_N, BENCH_J, BENCH_C = 8192, 32768, (9, 32, 64)
SKEW_N = 65535  # the scatter-add's outputs a row at its limit, in phase 4
FUSED_C, FUSED_F = 9, 32  # bench_fused_sa's layer 0
# whole-scene training: scenes, micro-batch and epochs of the CLI run; the
# card-vs-CPU scene (columns, micro-batch)
WS_SCENES, WS_BATCH, WS_EPOCHS = 4, 16, 2
WS_CHECK_COLUMNS, WS_CHECK_BATCH = 3, 2
# phase 21: synthetic scenes of the eval and visualize runs; the share of
# points at which the card's and the CPU's labels must agree (f32 matmuls sum
# in another order on each: a near-tie may flip)
EVAL_SCENES, EVAL_AGREE = 4, 0.999
# phase 22: scenes of the host-vs-resident Solver runs (1 step an epoch)
RESIDENT_SCENES = 32
# the columns of the serving runs' card-vs-CPU logit check, whose CPU forward
# is the longest part of a serving run
CHECK_COLUMNS = 8
# phase 23, bfloat16: the payload widths beyond the features (xyz_hi, xyz_lo),
# the odd payload of a 3-channel input (6 + 3), and the gates of the card
# against the CPU, the CPU tests' bounds against the JAX package
# (tests/test_torch_bf16_model.py): logits within 4% of the largest |logit|,
# labels equal at 99% of the points counting bfloat16 ties, the loss within
# 2e-3 relative; the card's bfloat16 gradients (relative L2 over all
# parameters, and the median tensor's) at most 1.25 times as far from a
# float64 CPU step as the CPU's bfloat16 gradients are (measured at most
# 1.06; h's output halved: 1.40), and at the median tensor no further from
# the CPU's bfloat16 gradients than those are from the float64 step over
# all parameters (the CPU test's third gradient bound; measured 0.21 and
# 0.25 against 0.68 and 0.55 for SSG and MSG; h's output halved: 0.94)
BF16_XYZ, BF16_ODD_C = 6, 3
BF16_LOGIT_SCALE_TOL, BF16_LABEL_AGREE = 0.04, 0.99
BF16_LOSS_RTOL, BF16_GRAD_VS_CPU = 2e-3, 1.25
# phase 24: f (P1's grouping gradients at SA2 and SA3) reaches only SA1's
# and SA2's parameters, so its output halved moves the bfloat16 gradients
# over all parameters less than BF16_GRAD_VS_CPU times further from the
# float64 step (PERF.md, section 6); the card's step under P1 must also give
# each of f's outputs bit for bit as its plain version does on CPU copies
# of that launch's inputs
# phase 26, multiview and the mv131 recipe (xyz + normal + 128-d ENet
# features: 131 input channels, the reference's best published recipe).
# ENet in float32 (TF32 off) on ENET_BATCH frames, card against CPU from the
# same seeded weights, within the JAX package's reference-parity tolerance
# (tests/test_multiview.py:165); the correspondence of one synthetic scene
# of MV_POINTS points seen by MV_FRAMES cameras, card against CPU: at most
# MV_FLIP_SHARE of the (frame, point) pairs may differ, each within
# MV_FLIP_MARGIN of a decision threshold (data/multiview.decision_margins;
# the CPU tests measured none against the JAX package); the mv131 Solver
# run's train and val scenes
MV131 = 131
ENET_BATCH, ENET_RTOL, ENET_ATOL = 8, 1e-3, 1e-4
MV_POINTS, MV_FRAMES = 100_000, 16
MV_FLIP_SHARE, MV_FLIP_MARGIN = 1e-5, 1e-4
MV_SCENES, MV_VAL_SCENES = 32, 2
# phase 27, data parallelism: the ranks sharing the card, the global
# batch, the Solver run's scenes and epochs, the eval scenes, and the
# steady-step timing (warm steps, timed steps a rank)
DP_RANKS, DP_BATCH = 2, 32
DP_SCENES, DP_EPOCHS, DP_EVAL_SCENES = 32, 2, 4
# (b)'s whole-scene update: the scene's first columns and the micro-batch
# (the padded one's rows on rank 1 all padding)
DP_WS_COLUMNS, DP_WS_BATCH = 20, 16
# (b)'s gradient bound, in units of phase 11's float32 noise: were the
# two-rank and the single-process float32 gradients each within phase 11's
# bound of the float64 gradient (TRAIN_GRAD_VS_CPU times the noise), they
# would lie within twice that of each other
DP_GRAD_BOUND = 2 * TRAIN_GRAD_VS_CPU
DP_WARM, DP_TIMED = 2, 5
# phase 28, the fused steps: K steps a CUDA graph launch (the train CLI's
# default); the timing windows (steps a window, windows; one NCCL rank's
# windows shorter); the two gloo ranks' store runs and the train CLI run,
# at batch 4 over phase 10's 32 scenes so that an epoch is one group of K
# (16 scenes a rank: one group), the ranks' scenes of FUSED_DP_POINTS
FUSED_K = 8
FUSED_WINDOW_STEPS, FUSED_WINDOWS, FUSED_NCCL_WINDOW_STEPS = 24, 3, 8
FUSED_SCENES, FUSED_BATCH, FUSED_DP_POINTS = 32, 4, 30_000
# phase 29, the shape families (engine/shape_runs.py) at their published
# recipes (1024 points; cls batch 32 over 8 classes, partseg batch 16 over
# 8 categories): the CLI runs' epochs, train and val batches an epoch; the
# card-vs-CPU steps' clouds (cls SSG 8: its head's BatchNorm normalises over
# the batch's vectors alone; partseg MSG 1: over its points); the steady
# step's warm steps, steps a window and windows
SHAPE_VARIANTS = (("cls", False), ("cls", True), ("partseg", False), ("partseg", True))
SHAPE_BATCH = {"cls": 32, "partseg": 16}
SHAPE_NPOINTS, SHAPE_COUNT = 1024, 8
SHAPE_EPOCHS, SHAPE_TRAIN_BATCHES, SHAPE_VAL_BATCHES = 2, 3, 1
SHAPE_CHECK_BATCH = {"cls": 8, "partseg": 1}
# the families' float32 gradient noise: one near-tie of a max or a ReLU that
# rounds the other way moves every gradient, 2-4e-3 relative over all
# parameters, and the CPU's step may land on either side (measured on an
# H100 against the CPU's float64 step: cls SSG at 8 clouds, card 2.5e-3,
# CPU 1.4e-5; at 32, 2.4e-3 and 3.1e-3; partseg MSG at 1 cloud, card
# 9.6e-6, CPU 4.1e-3), so the card's distance is held to TRAIN_GRAD_VS_CPU
# times the larger of the CPU's and this floor
SHAPE_GRAD_FLOOR = 5e-3
SHAPE_WARM, SHAPE_STEPS, SHAPE_WINDOWS = 3, 10, 3
# phase 30, the votenet modules at VoteNet's widths (Qi et al., ICCV 2019;
# its models/backbone_module.py and proposal_module.py): scenes of
# VOTE_POINTS points with one feature channel (height); the backbone's SA1-SA4
# (npoint, radius, nsample, widths), all with normalize_xyz; the proposal
# SA on SA2's 1024 seeds of 256 channels (VoteNet's seeds after FP2); the
# JAX msg_spec's SA1 and SA2 (models/pointnet2.py:79-86) as
# SetAbstractionMSGVotes, and an LFP from MSG SA2 back onto MSG SA1's points
# at SA2's radii, nsamples and widths with FP1's (256, 256) as its post_mlp;
# the card-vs-CPU step's scenes; the timing's warm calls, calls a window and
# windows; the synthetic raw scan's mesh and the normals' bound card vs CPU
VOTE_BATCH, VOTE_POINTS, VOTE_CHECK_BATCH = 8, 20_000, 2
VOTE_SA = ((2048, 0.2, 64, (64, 64, 128)), (1024, 0.4, 32, (128, 128, 256)),
           (512, 0.8, 16, (128, 128, 256)), (256, 1.2, 16, (128, 128, 256)))
VOTE_PROPOSAL = (256, 0.3, 16, (128, 128, 128))
VOTE_MSG = ((1024, (0.05, 0.1), (16, 32), ((16, 16, 32), (32, 32, 64))),
            (256, (0.1, 0.2), (16, 32), ((64, 64, 128), (64, 96, 128))))
VOTE_LFP_POST = (256, 256)
VOTE_WARM, VOTE_STEPS, VOTE_WINDOWS = 2, 5, 3
PREP_VERTICES, PREP_FACES, PREP_NORMAL_TOL = 100_000, 200_000, 1e-6
# phase 31, tensor parallelism: the ranks of the dp 1 x tp 2 grid sharing the
# card, the columns both ranks take, the Solver run's epochs (a resume adds
# one) and the steady step's warm and timed steps (a rank)
TP_RANKS, TP_BATCH, TP_EPOCHS = 2, 32, 2
TP_WARM, TP_TIMED = 1, 3
# the wrappers of the path's kernels: (counter name, module, op), each
# <op>_cuda held against <op>_plain in phase 31 (c)
PATH_WRAPPERS = (("furthest_point_sample", "fps_kernel", "furthest_point_sample"),
                 ("ball_query", "ball_query_kernel", "ball_query"),
                 ("ball_query_multi", "ball_query_multi_kernel", "ball_query_multi"),
                 ("gather", "gather_kernel", "gather"), ("scatter_add", "scatter_kernel", "scatter_add"),
                 ("three_nn", "three_nn_kernel", "three_nn"))
# the hand-written kernels a replay's trace may name, by TPU kernel letter
# (b and c share ball_scan.cuh's kernels: one radius row, or two)
TRACE_LETTERS = (("a", r"fps(_cluster)?_kernel\b"), ("b", r"ball_query_(resident|tiled)_kernel<1>"),
                 ("c", r"ball_query_(resident|tiled)_kernel<2>"), ("d", r"gather_kernel\b"),
                 ("h", r"block_kernel\b"), ("i", r"three_nn_kernel\b"))
LETTER_KERNEL = {"a": "furthest_point_sample", "b": "ball_query", "c": "ball_query_multi", "d": "gather",
                 "h": "scatter_add", "i": "three_nn"}
# kernels that only a switch, a shape or a bench script selects
OFF_BY_DEFAULT = {"gather_smem", "scatter_smem", "three_nn_q", "gather_split", "fused_gather_mm"}
# phase 32, the op-lowering switches: the interpolation forms' float32
# bound against the CPU and the gather form (of the largest |value|;
# bfloat16: 2 ulps of it), and the batch rows the CPU checks
INTERP_F32_TOL, INTERP_CPU_ROWS = 1e-5, 4


def cuda_ms(fn, torch) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up, over
    enough calls to fill about 0.2 s."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """The least ms the card could take for the work, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Tally:
    """One kernel's row of the JSON line: times, errors and bounds summed
    over the shapes it was checked at in this run, and per model path."""

    def __init__(self, module, name: str | None = None):
        self.module = module
        self.name = name or module.NAME
        self.max_abs_err = 0.0
        self.paths: dict[str, dict] = {}

    def add(self, path, ms, plain_ms, err, nbytes, nops, library_ms=None, **extra):
        b, by = bound_ms(nbytes, nops)
        p = self.paths.setdefault(path, {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                         "bytes": 0.0, "operations": 0.0})
        p["ms"] += ms
        p["plain_ms"] += plain_ms
        p[by] += b
        if library_ms is not None:
            p["library_ms"] = (p["library_ms"] or 0.0) + library_ms
        for k, v in extra.items():
            p[k] = p.get(k, 0.0) + v
        self.max_abs_err = max(self.max_abs_err, err)

    def total(self, key):
        vals = [p[key] for p in self.paths.values() if p.get(key) is not None]
        return sum(vals) if vals else None

    def row(self, launches: int) -> dict:
        spent = {by: self.total(by) for by in ("bytes", "operations")}
        row = {
            "name": self.name,
            "route": "cuda",
            "source": self.module.SOURCE,
            "replaces": self.module.REPLACES,
            "launches": launches,
            "max_abs_err": self.max_abs_err,
            "ms": self.total("ms"),
            "plain_ms": self.total("plain_ms"),
            "bound_ms": spent["bytes"] + spent["operations"],
            "bound_by": max(spent, key=spent.get),
            "library_ms": self.total("library_ms"),
        }
        for key in ("two_single_ms", "counterpart_ms"):
            if self.total(key) is not None:
                row[key] = self.total(key)
        return row


def check(torch, tally, path, label, kernel_fn, plain_fn, nbytes, nops, library_fn=None, steps=None,
          **extra):
    """A kernel against its plain version on the card, bit for bit, then
    both timed (and the library call, where there is one); with steps, the
    kernel's µs a step too."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    ms, plain_ms = cuda_ms(kernel_fn, torch), cuda_ms(plain_fn, torch)
    library_ms = cuda_ms(library_fn, torch) if library_fn is not None else None
    extra = {k: cuda_ms(fn, torch) for k, fn in extra.items()}
    tally.add(path, ms, plain_ms, err, nbytes, nops, library_ms, **extra)
    b, by = bound_ms(nbytes, nops)
    more = "".join(f", {k} {v:.4f} ms" for k, v in extra.items())
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    per_step = f" ({1e3 * ms / steps:.3f} us a step)" if steps else ""
    print(f"kernel {label}: {ms:.4f} ms{per_step}, plain {plain_ms:.4f} ms{lib}{more}, bound {b:.4f} ms "
          f"({by}), max_abs_err {err}, {'equal' if equal else 'DIFFERENT'}", flush=True)
    if not equal:
        raise RuntimeError(f"{label}: kernel and plain version differ (max_abs_err {err})")


def distinct_rows(idx) -> int:
    """Source rows a gather through idx (B, J) reads: the distinct indices
    of each batch row, summed."""
    s = idx.sort(dim=1).values
    return idx.shape[0] + int((s[:, 1:] != s[:, :-1]).sum())


def gather_check(torch, tally, path, label, src, idx):
    """The gather kernel at one shape, with torch.gather on an int64 index
    made beforehand as the library call."""
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    (b, _, c), j, e = src.shape, idx.shape[1], src.element_size()
    index = idx.long().unsqueeze(-1).expand(-1, -1, c)
    check(torch, tally, path, label, lambda: ga.gather_cuda(src, idx),
          lambda: ga.gather_plain(src, idx), e * (distinct_rows(idx) * c + b * j * c) + 4 * b * j, 0,
          library_fn=lambda: torch.gather(src, 1, index))


def serving_columns(n_scenes: int, npoints: int = NPOINTS):
    """Whole-scene columns of the synthetic scenes the serving run uses."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import WholeSceneDataset, make_synthetic_store

    cfg = DataConfig(npoints=npoints, use_color=True, use_normal=True)
    ds = WholeSceneDataset(make_synthetic_store(n_scenes, seed=1000), cfg, seed=0)
    import numpy as np

    return np.concatenate([ds.get_scene(i)[0] for i in range(len(ds))])


def level_clouds(torch):
    """xyz of the five point sets (8192, 1024, 256, 64, 16 points) of a batch
    of 32 real synthetic columns, each level from the plain FPS of the one
    above, the FPS indices, and the input features."""
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps, gather_kernel as ga

    cols = serving_columns(2)
    if len(cols) < BATCH:
        raise RuntimeError(f"only {len(cols)} columns for a batch of {BATCH}")
    cols = torch.from_numpy(cols[:BATCH]).to("cuda")
    xyz = [cols[..., :3].contiguous()]
    fps_idx = []
    for _, n_out, _, _ in LEVELS:
        fps_idx.append(fps.furthest_point_sample_plain(xyz[-1], n_out))
        xyz.append(ga.gather_plain(xyz[-1], fps_idx[-1]).contiguous())
    return xyz, fps_idx, cols[..., 3:].contiguous()


def check_queries(torch, tallies, path, x, q, radius):
    """The ball query (b) and 3-NN (i) at one level against their plain
    versions, each labelled with its plan()."""
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3
    from pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter import scan_points

    (b, n, _), m = x.shape, q.shape[1]
    sms = build.sm_count(x)
    scans = int(scan_points(torch, x, q, radius, NSAMPLE).sum())
    check(torch, tallies[bq.NAME], path,
          f"ball_query r={radius} ({b},{n})->{m} ns={NSAMPLE} plan {tuple(bq.plan(b, n, m, sms))}",
          lambda: bq.ball_query_cuda(radius, NSAMPLE, x, q),
          lambda: bq.ball_query_plain(radius, NSAMPLE, x, q),
          4 * b * (3 * n + 3 * m + m * NSAMPLE), 9 * scans)
    check(torch, tallies[nn3.NAME], path, f"three_nn ({b},{n},{m}) plan {tuple(nn3.plan(b, n, m, sms))}",
          lambda: nn3.three_nn_cuda(x, q), lambda: nn3.three_nn_plain(x, q),
          4 * b * (3 * n + 3 * m + 6 * n), 9 * b * n * m)


def check_kernels(torch, tallies, xyz, fps_idx, input_feats) -> list:
    """Phase 3: every forward kernel vs its plain version at the SSG path's
    shapes. Returns the (label, idx (B, J), N, C) of every gather whose
    gradient the SSG train step takes, from these ball-query and 3-NN
    outputs."""
    from pointnet2_scannet_tpu_torch.ops.cuda import (
        ball_query_kernel as bq,
        fps_kernel as fps,
        gather_kernel as ga,
        three_nn_kernel as nn3,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = [input_feats]
    for _, _, _, c in LEVELS[1:]:
        feats.append(torch.randn((BATCH, xyz[len(feats)].shape[1], c), generator=gen, device="cuda"))
    backward = []
    for k, (n_in, n_out, radius, c) in enumerate(LEVELS):
        x, q = xyz[k], xyz[k + 1]
        check(torch, tallies[fps.NAME], "ssg", f"fps {n_in}->{n_out} plan {tuple(fps.plan(n_in, x.dtype))}",
              lambda: fps.furthest_point_sample_cuda(x, n_out),
              lambda: fps.furthest_point_sample_plain(x, n_out),
              4 * BATCH * (3 * n_in + n_out), 10 * BATCH * (n_out - 1) * n_in, steps=n_out - 1)
        gather_check(torch, tallies[ga.NAME], "ssg", f"gather centroids ({BATCH},{n_in},3)x{n_out}",
                     x, fps_idx[k])
        check_queries(torch, tallies, "ssg", x, q, radius)
        nidx = bq.ball_query_cuda(radius, NSAMPLE, x, q).reshape(BATCH, -1)
        src = torch.cat([x, feats[k]], dim=-1).contiguous()
        gather_check(torch, tallies[ga.NAME], "ssg",
                     f"gather grouping ({BATCH},{n_in},{3 + c})x{nidx.shape[1]}", src, nidx)
        if k > 0:  # SA1 groups input data: no gradient is taken there
            backward.append((f"SA{k + 1} grouping", nidx, n_in, 3 + c))
        nn_idx = nn3.three_nn_cuda(x, q)[1].reshape(BATCH, -1)
        known = torch.randn((BATCH, n_out, FP_CHANNELS[k]), generator=gen, device="cuda")
        gather_check(torch, tallies[ga.NAME], "ssg fp",
                     f"gather FP{k} interpolation ({BATCH},{n_out},{FP_CHANNELS[k]})x{nn_idx.shape[1]}",
                     known, nn_idx)
        backward.append((f"FP{k} interpolation", nn_idx, n_out, FP_CHANNELS[k]))
    return backward


def check_scatter(torch, tally, path, backward, dtype=None) -> None:
    """Phases 4, 6, 8, 23, 24 and 26: a scatter-add kernel (the tally's:
    scatter_add.cu, or scatter_smem.cu with scatter_add.cu as its
    counterpart) against its plain version on CPU copies (which adds in
    ascending j, as the kernels do; bfloat16 cotangents in float32, rounded
    once for h, a tile at a time for f) and against a second launch, bit for
    bit; times against the plain version on the card (unordered atomics)
    and against scatter_add_ on an int64 index made beforehand (on float32
    copies of bfloat16 cotangents: one rounding, so another function for
    f), beside the route its plan() takes. dtype: the cotangents' (float32
    by default)."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc

    mod = tally.module
    kernel, plain = getattr(mod, f"{mod.NAME}_cuda"), getattr(mod, f"{mod.NAME}_plain")
    extra = {} if mod is sc else {"counterpart_ms": sc.scatter_add_cuda}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, idx, n, c in sorted(backward, key=lambda b: b[0]):
        b, j = idx.shape
        g = torch.randn((b, j, c), generator=gen, device="cuda")
        g *= 10.0 ** (torch.rand((b, j, 1), generator=gen, device="cuda") * 6 - 3)
        g32 = g
        if dtype is not None:
            g = g.to(dtype)
            g32 = g.float()
        got = kernel(idx, g, n)
        again = kernel(idx, g, n)
        want = plain(idx.cpu(), g.cpu(), n)
        got = got.cpu()
        err = float((got.double() - want.double()).abs().max())
        equal = torch.equal(got, want)
        repeat = torch.equal(again.cpu(), got)
        index = idx.long().unsqueeze(-1).expand(b, j, c)
        ms = cuda_ms(lambda: kernel(idx, g, n), torch)
        plain_ms = cuda_ms(lambda: plain(idx, g, n), torch)
        library_ms = cuda_ms(lambda: torch.zeros((b, n, c), device="cuda").scatter_add_(
            1, index, g32), torch)
        more = {k: cuda_ms(lambda: fn(idx, g, n), torch) for k, fn in extra.items()}
        nbytes, nops = 4 * b * j + g.element_size() * (b * j * c + b * n * c), b * j * c
        tally.add(path, ms, plain_ms, err, nbytes, nops, library_ms, **more)
        bound, by = bound_ms(nbytes, nops)
        sms = build.sm_count(g)
        route = mod.plan(b, n, j, c, sms, g.element_size())
        print(f"kernel {mod.NAME} {path.upper()} {label} (B={b}, J={j}, N={n}, C={c}, {g.dtype}): "
              f"{ms:.4f} ms, route {type(route).__name__}{tuple(route)}, plain on the card "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms"
              + "".join(f", {k} {v:.4f} ms" for k, v in more.items())
              + f", bound {bound:.4f} ms ({by}), max_abs_err vs CPU plain {err}, "
              f"{'equal' if equal else 'DIFFERENT'}, second launch "
              f"{'equal' if repeat else 'DIFFERENT'}", flush=True)
        if not (equal and repeat):
            raise RuntimeError(f"{mod.NAME} {label}: kernel differs from the CPU plain version "
                               f"or from its own second launch (max_abs_err {err})")


def skewed_row(torch) -> list:
    """Phase 4's check past the train steps' shapes: N = 65535 outputs, one
    of them named about 1000 times among uniform indices (B 2, J 131072, C
    64), as check_scatter takes it."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(0, SKEW_N, (2, 131072), generator=gen, device="cuda", dtype=torch.int32)
    idx[:, torch.randperm(131072, generator=gen, device="cuda")[:1000]] = 4321
    return [(f"N={SKEW_N} skewed row", idx, SKEW_N, 64)]


def check_multi(torch, tallies, xyz) -> list:
    """Phase 5: the two-radius ball query at the four MSG levels, bit for
    bit against its plain version, timed beside two single-radius launches.
    Returns each level's (idx1, idx2)."""
    from pointnet2_scannet_tpu_torch.models import msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter import scan_points

    spec = msg_spec(20, 6)
    out = []
    for k, (radii, ks) in enumerate(zip(spec.radii, spec.nsamples)):
        x, q = xyz[k], xyz[k + 1]
        n, m = x.shape[1], q.shape[1]
        scans = int(torch.maximum(scan_points(torch, x, q, radii[0], ks[0]),
                                  scan_points(torch, x, q, radii[1], ks[1])).sum())
        check(torch, tallies[bqm.NAME], "msg",
              f"ball_query_multi r={radii} N={n} M={m} ns={ks} plan "
              f"{tuple(bqm.plan(BATCH, n, m, build.sm_count(x)))}",
              lambda: bqm.ball_query_multi_cuda(radii, ks, x, q),
              lambda: bqm.ball_query_multi_plain(radii, ks, x, q),
              4 * BATCH * (3 * n + 3 * m + m * sum(ks)), 10 * scans,
              two_single_ms=lambda: (bq.ball_query_cuda(radii[0], ks[0], x, q),
                                     bq.ball_query_cuda(radii[1], ks[1], x, q)))
        out.append(bqm.ball_query_multi_cuda(radii, ks, x, q))
    return out


def check_msg_gathers(torch, tallies, xyz, input_feats, multi_idx) -> list:
    """Phase 6: the gather at every shape of the MSG forward, listed from the
    MSG model: per level and scale, its pregather gate decides between one
    grouping gather of [xyz | features] (3 + C words a row) and the
    pregather's gathers of layer 0's output (widths[0] words) and the
    centred xyz (3 words); then each FP level's interpolation gather. Returns
    the (label, idx, N, C) of every gather whose gradient the MSG train step
    takes."""
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3

    spec = msg_spec(20, 6)
    model = PointNet2SemSeg(spec)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tally = tallies[ga.NAME]
    backward = []
    for k in range(len(spec.npoints)):
        sa = getattr(model, f"sa_{k}")
        c, x = spec.skip_channels[k], xyz[k]
        n = x.shape[1]
        feats = input_feats if k == 0 else torch.randn((BATCH, n, c), generator=gen, device="cuda")
        for s, mlp in enumerate(sa._mlps()):
            idx = multi_idx[k][s].reshape(BATCH, -1)
            where = f"SA{k + 1} scale {s}"
            if sa._pregather(torch.empty((1, 1, c)), mlp.widths):
                zf = torch.randn((BATCH, n, mlp.widths[0]), generator=gen, device="cuda")
                gathers = [(f"{where} pregather zf", zf, True), (f"{where} pregather xyz", x, False)]
            else:  # SA1 groups input data: no gradient is taken there
                src = torch.cat([x, feats], dim=-1).contiguous()
                gathers = [(f"{where} grouping", src, k > 0)]
            for label, src, grad in gathers:
                gather_check(torch, tally, "msg",
                             f"gather MSG {label} ({BATCH},{n},{src.shape[2]})x{idx.shape[1]}", src, idx)
                if grad:
                    backward.append((label, idx, n, src.shape[2]))
    for k in range(len(spec.fp_mlps)):
        c = spec.sa_out_channels[-1] if k == len(spec.fp_mlps) - 1 else spec.fp_mlps[k + 1][-1]
        x, q = xyz[k], xyz[k + 1]
        nn_idx = nn3.three_nn_cuda(x, q)[1].reshape(BATCH, -1)
        known = torch.randn((BATCH, q.shape[1], c), generator=gen, device="cuda")
        gather_check(torch, tally, "msg",
                     f"gather MSG FP{k} interpolation ({BATCH},{q.shape[1]},{c})x{nn_idx.shape[1]}",
                     known, nn_idx)
        backward.append((f"FP{k} interpolation", nn_idx, q.shape[1], c))
    return backward


def check_mv131_gathers(torch, tallies, xyz) -> None:
    """Phase 26's kernel checks, run with phases 3 and 4: the mv131 recipe
    (131 input channels) takes the pregather at SSG's SA1, so the gather
    (d) moves layer 0's output (widths[0] words a row) and the xyz (3)
    through SA1's ball-query index, and the scatter-add (h) takes the first
    one's gradient back to the 8192 source rows. Both as check_kernels and
    check_scatter hold them, at the shapes the SSG model's gate gives."""
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, ssg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    spec = ssg_spec(20, MV131)
    sa = PointNet2SemSeg(spec).sa_0
    widths = sa._mlps()[0].widths
    if not sa._pregather(torch.empty((1, 1, spec.skip_channels[0])), widths):
        raise RuntimeError("the mv131 recipe's SA1 does not take the pregather")
    (n_in, _, radius, _), x = LEVELS[0], xyz[0]
    idx = bq.ball_query_cuda(radius, NSAMPLE, x, xyz[1]).reshape(BATCH, -1)
    gen = torch.Generator(device="cuda").manual_seed(4)
    zf = torch.randn((BATCH, n_in, widths[0]), generator=gen, device="cuda")
    for what, src in (("zf", zf), ("xyz", x)):
        gather_check(torch, tallies[ga.NAME], "mv131",
                     f"gather SSG mv131 SA1 pregather {what} ({BATCH},{n_in},{src.shape[2]})x{idx.shape[1]}",
                     src, idx)
    # the xyz are input data: only layer 0's output takes a gradient
    check_scatter(torch, tallies["scatter_add"], "mv131", [("SA1 mv131 pregather zf", idx, n_in, widths[0])])


def time_pregather(torch, kind: str = "msg", input_channels: int = 6) -> None:
    """Phases 7 and 26: the model at 32 x 8192 with its pregather gate as it
    stands (MSG: on at SA3 and SA4 in float32; SSG at the mv131 recipe's 131
    input channels: on at SA1) and forced off (the unfused composition at
    every level). The eval logits of the two must agree; the serving
    forward and the train step (and for mv131 SA1's forward alone) are
    timed with CUDA events, in the order on, off, off, on. For MSG, the
    switches of P1 are process-wide, so the gate-on forward runs under
    MXU_CONFIG too: its logits must equal the default configuration's bit
    for bit, with gather_smem.cu launched."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    batch = train_batch(torch, BATCH, "cuda", input_channels=input_channels)
    state = bench_torch.fresh_state(kind, "cuda", 0.5, input_channels=input_channels)
    model = state.model
    gate = pregather_gate(model)
    pc = batch["points"]

    def inference(fn):
        def run():
            model.eval()
            with torch.inference_mode():
                return fn()
        return run

    forward = inference(lambda: model(pc))
    timed = {"serve forward": forward, "train step": lambda: ts.train_step(state, batch, num_classes=20)}
    name = f"{kind.upper()} (B={BATCH} x {NPOINTS})"
    if input_channels == MV131:
        xyz, feats = pc[..., :3].contiguous(), pc[..., 3:].contiguous()
        timed = {"SA1 forward": inference(lambda: model.sa_0(xyz, feats)), **timed}
        name = f"{kind.upper()} mv131 (B={BATCH} x {NPOINTS}, {MV131} input channels)"
    logits = {}
    for on in (True, False):
        gate(on)
        logits[on] = forward()
    torch.testing.assert_close(logits[True], logits[False], rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    err = float((logits[True] - logits[False]).abs().max())
    gate(True)
    if kind == "msg":
        before = kernels.launch_counts()
        with switches(**MXU_CONFIG):
            mxu = forward()
        ran = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
        print(f"MSG under P1's switches (B={BATCH} x {NPOINTS}): launches {ran}; eval logits vs the "
              f"default configuration max_abs_err {float((mxu - logits[True]).abs().max())}", flush=True)
        if not ran.get("gather_smem") or not torch.equal(mxu, logits[True]):
            raise RuntimeError("the MSG forward under P1's switches launched no gather_smem kernel "
                               "or differs from the default configuration's")
    times = {(on, what): [] for on in (True, False) for what in timed}
    for on in (True, False, False, True):
        gate(on)
        for what, fn in timed.items():
            times[(on, what)].append(cuda_ms(fn, torch))
    gate(True)
    print(f"pregather {name}: logits gate on vs off max_abs_err {err}; "
          + "; ".join(f"{what} gate {'on' if on else 'off'} "
                      + " / ".join(f"{t:.3f}" for t in ms) + " ms"
                      for (on, what), ms in times.items()), flush=True)


@contextlib.contextmanager
def switches(**fields):
    """Set ops_config fields for the duration, then restore them."""
    from pointnet2_scannet_tpu_torch.ops import tuning

    saved = {k: getattr(tuning.ops_config, k) for k in fields}
    for k, v in fields.items():
        setattr(tuning.ops_config, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(tuning.ops_config, k, v)


def smem_gather_check(torch, tally, path, label, src, idx, kernel, plain) -> None:
    """Phases 8 and 24: e or g (kernel) at one shape against its plain
    version, beside torch.gather on an int64 index made beforehand and d
    (gather.cu), its counterpart."""
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    (b, _, c), j, e = src.shape, idx.shape[1], src.element_size()
    index = idx.long().unsqueeze(-1).expand(-1, -1, c)
    check(torch, tally, path, label, lambda: kernel(src, idx), lambda: plain(src, idx),
          e * (distinct_rows(idx) * c + b * j * c) + 4 * b * j, 0,
          library_fn=lambda: torch.gather(src, 1, index),
          counterpart_ms=lambda: ga.gather_cuda(src, idx))


def check_switched_kernels(torch, tallies, xyz, fps_idx, input_feats) -> None:
    """Phase 8: e, f, g and j bit for bit against their plain versions, timed
    beside them, their older counterparts (d, h, d, i) and the library call.
    The P1 shapes are the gathers that gather_route sends to the MXU route in
    the SSG model under MXU_CONFIG, listed from LEVELS."""
    from pointnet2_scannet_tpu_torch.ops import tuning
    from pointnet2_scannet_tpu_torch.ops.cuda import (
        ball_query_kernel as bq,
        gather_smem_kernel as gs,
        gather_split_kernel as gsp,
        three_nn_kernel as nn3,
        three_nn_q_kernel as nnq,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    backward = []
    with switches(**MXU_CONFIG):
        for k, (n_in, n_out, radius, c) in enumerate(LEVELS):
            x, q = xyz[k], xyz[k + 1]
            feats = input_feats if k == 0 else torch.randn((BATCH, n_in, c), generator=gen, device="cuda")
            nidx = bq.ball_query_cuda(radius, NSAMPLE, x, q).reshape(BATCH, -1)
            for what, src, idx, grad in (
                ("centroids", x, fps_idx[k], False),
                ("grouping", torch.cat([x, feats], dim=-1).contiguous(), nidx, k > 0),
            ):
                (_, n, width), j = src.shape, idx.shape[1]
                if tuning.gather_route(n, j, width, src.dtype) != "mxu":
                    continue
                smem_gather_check(torch, tallies[gs.NAME], "p1",
                                  f"gather_smem P1 SA{k + 1} {what} ({BATCH},{n},{width})x{j}",
                                  src, idx, gs.gather_smem_cuda, gs.gather_smem_plain)
                if grad:
                    backward.append((f"SA{k + 1} grouping", idx, n, width))
    check_scatter(torch, tallies["scatter_smem"], "p1", backward)

    backward = []
    for c in BENCH_C:
        src = torch.randn((BATCH, BENCH_N, c), generator=gen, device="cuda")
        idx = torch.randint(0, BENCH_N, (BATCH, BENCH_J), generator=gen, device="cuda", dtype=torch.int32)
        shape = f"({BATCH},{BENCH_N},{c})x{BENCH_J}"
        smem_gather_check(torch, tallies[gs.NAME], "bench", f"gather_smem bench {shape}", src, idx,
                          gs.gather_smem_cuda, gs.gather_smem_plain)
        smem_gather_check(torch, tallies[gsp.NAME], "bench", f"gather_split bench {shape}", src, idx,
                          gsp.gather_split_cuda, gsp.gather_split_plain)
        backward.append((f"bench C={c:02d}", idx, BENCH_N, c))
    check_scatter(torch, tallies["scatter_smem"], "bench", backward)

    # FP0 of 7936-point columns (their first 7936 points, the level-1
    # centroids as the known set) and n = m = 8192 (another column's points)
    for path, unknown, known in (("p2", xyz[0][:, :P2_NPOINTS[1]].contiguous(), xyz[1]),
                                 ("m>4096", xyz[0], xyz[0].roll(1, dims=0).contiguous())):
        n, m = unknown.shape[1], known.shape[1]
        if tuning.three_nn_route(n, m) != "q":
            raise RuntimeError(f"three_nn n={n} m={m} does not route to the query-major kernel")
        check(torch, tallies[nnq.NAME], path, f"three_nn_q n={n} m={m}",
              lambda: nnq.three_nn_q_cuda(unknown, known), lambda: nnq.three_nn_q_plain(unknown, known),
              4 * BATCH * (3 * n + 3 * m + 6 * n), 9 * BATCH * n * m,
              counterpart_ms=lambda: nn3.three_nn_cuda(unknown, known))
        got, want = nnq.three_nn_q_cuda(unknown, known), nn3.three_nn_cuda(unknown, known)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"three_nn_q n={n} m={m} differs from three_nn.cu")


def check_fused(torch, tallies) -> None:
    """Phase 8, k: the fused gather-matmul against its plain version at
    bench_fused_sa.py's shape, bit for bit, timed beside the plain version,
    the unfused composition it replaces (d, then torch.matmul) and its
    general route (w in shared memory, the earlier design); then its device
    time from torch.profiler. No single PyTorch call gathers and multiplies: no
    library call."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter import device_ms

    gen = torch.Generator(device="cuda").manual_seed(4)
    c, f, j = FUSED_C, FUSED_F, BENCH_J
    src = torch.randn((BATCH, BENCH_N, c), generator=gen, device="cuda")
    idx = torch.randint(0, BENCH_N, (BATCH, j), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.randn((c, f), generator=gen, device="cuda") * 0.1
    p = fk.plan(BATCH, BENCH_N, j, c, f, build.sm_count(src))
    general = fk.candidate_plans(BATCH, BENCH_N, j, c, f, build.sm_count(src))[-1]
    out = torch.empty((BATCH, j, f), device="cuda")
    if not torch.equal(fk.launch(src, idx, w, out, general), fk.fused_gather_mm_plain(src, idx, w)):
        raise RuntimeError("fused_gather_mm's general route differs from the plain version")
    check(torch, tallies[fk.NAME], "bench",
          f"fused_gather_mm bench ({BATCH},{BENCH_N},{c})x{j}x({c},{f}) plan {tuple(p)}",
          lambda: fk.fused_gather_mm_cuda(src, idx, w), lambda: fk.fused_gather_mm_plain(src, idx, w),
          4 * (distinct_rows(idx) * c + BATCH * j + c * f + BATCH * j * f), 2 * BATCH * j * c * f,
          counterpart_ms=lambda: ga.gather_cuda(src, idx) @ w,
          general_route_ms=lambda: fk.launch(src, idx, w, out, general))
    runs = {f"plan {tuple(p)}": lambda: fk.fused_gather_mm_cuda(src, idx, w),
            f"general route {tuple(general)}": lambda: fk.launch(src, idx, w, out, general)}
    print("kernel fused_gather_mm bench device ms (torch.profiler): " + ", ".join(
        f"{label} {sum(device_ms(torch, fn).values()):.4f}" for label, fn in runs.items()), flush=True)


def check_p3_fps(torch, tally) -> None:
    """Phase 18: FPS against its plain version at P3_FPS's shapes, bit for
    bit: synthetic columns of that many points, with the first row's first
    points at the origin and the last row's second half a copy of its first
    (exact ties across the blocks of a cluster), in float32 and float64;
    each line with µs a step and the plan."""
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps

    for b, n, dtype, m in P3_FPS:
        xyz = torch.from_numpy(serving_columns(2, n)[:b, :, :3]).to("cuda", getattr(torch, dtype))
        xyz[0, :5] = 0.0
        xyz[-1, n // 2:] = xyz[-1, : n - n // 2].clone()
        check(torch, tally, "p3", f"fps {dtype} ({b},{n})->{m} plan {tuple(fps.plan(n, xyz.dtype))}",
              lambda: fps.furthest_point_sample_cuda(xyz, m),
              lambda: fps.furthest_point_sample_plain(xyz, m),
              xyz.element_size() * b * 3 * n + 4 * b * m, 10 * b * (m - 1) * n, steps=m - 1)


def check_p3_queries(torch, tallies) -> None:
    """Phase 18: the ball query (b: the tiled route, SA1's radius) and 3-NN
    (i: FP0) against their plain versions, bit for bit, at P3's (8, 32768)
    -> 1024 on real synthetic columns, the centroids from the plain FPS."""
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps, gather_kernel as ga

    cols = serving_columns(2, P3_NPOINTS)[:P3_BATCH, :, :3]
    x = torch.from_numpy(cols).to("cuda").contiguous()
    q = ga.gather_plain(x, fps.furthest_point_sample_plain(x, P3_CENTROIDS)).contiguous()
    check_queries(torch, tallies, "p3", x, q, LEVELS[0][2])


def on_path(kind: str, training: bool, config: str = "default", npoints: int = NPOINTS) -> tuple[set, set]:
    """(kernels a run of the model must launch, kernels it must not), under
    the default configuration or P1's ("mxu"), at a column size."""
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops.tuning import three_nn_route

    other_query = "ball_query_multi" if kind == "ssg" else "ball_query"
    names = {k.NAME for k in kernels.KERNELS}
    on = set()
    if config == "mxu":
        on |= {"gather_smem", "scatter_smem"} if training else {"gather_smem"}
    if three_nn_route(npoints, 1024) == "q":  # FP0
        on.add("three_nn_q")
    # serving runs under inference_mode: no backward, so no scatter-add
    off = {other_query} | (set() if training else {"scatter_add"}) | (OFF_BY_DEFAULT - on)
    return names - off, off


def check_launches(launches: dict, kind: str, training: bool, what: str,
                   config: str = "default", npoints: int = NPOINTS) -> None:
    want, off = on_path(kind, training, config, npoints)
    missing = sorted(k for k in want if launches[k] == 0)
    stray = sorted(k for k in off if launches[k] != 0)
    if missing or stray:
        raise RuntimeError(f"the {what} run launched no {missing} kernel, or launched {stray}")
    # every forward runs FPS at the 4 levels and 3-NN at the 4 FP levels,
    # FP0 through the query-major kernel where it routes there; each level's
    # FPS takes the variant plan() gives its row size (a cluster of blocks a
    # row where the row outgrows one block)
    import torch

    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel

    forwards, rest = divmod(launches["furthest_point_sample"], 4)
    q = forwards if "three_nn_q" in want else 0
    if rest or launches["three_nn_q"] != q or launches["three_nn"] != 4 * forwards - q:
        raise RuntimeError(f"the {what} run made {forwards} forwards but launched 3-NN "
                           f"{launches['three_nn']} + {launches['three_nn_q']} (query-major) times")
    want = {variant: 0 for variant in fps_kernel.variant_launches}
    for n in (npoints, 1024, 256, 64):  # each level's points in
        want[fps_kernel.plan(n, torch.float32).variant] += forwards
    variants = fps_kernel.variant_launches
    if variants != want:
        raise RuntimeError(f"the {what} run made {forwards} forwards but launched FPS's variants {variants}")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_run(torch, run: pathlib.Path, kind: str, npoints: int = NPOINTS,
             compute_dtype: str = "float32") -> pathlib.Path:
    """A run dir of the SSG or MSG model at full width (xyz + colour +
    normal, 20 classes) with weights drawn from a seeded generator: the
    config.json and model_best.pt that train_torch.py writes."""
    from pointnet2_scannet_tpu_torch.config import DataConfig, ModelConfig, RunConfig
    from pointnet2_scannet_tpu_torch.engine.checkpoint import save_state_dict
    from pointnet2_scannet_tpu_torch.models import get_model

    run.mkdir()
    RunConfig(
        tag="chip_smoke",
        data=DataConfig(npoints=npoints, use_color=True, use_normal=True),
        model=ModelConfig(is_msg=kind == "msg", compute_dtype=compute_dtype),
    ).save(run / "config.json")
    model = get_model(20, is_msg=kind == "msg", input_channels=6,
                      generator=torch.Generator().manual_seed(0))
    save_state_dict(run, "model_best", model.state_dict())
    return run


def serve(torch, tmp: pathlib.Path, kind: str, config: str = "default", npoints: int = NPOINTS,
          batch_size: int = BATCH, bf16: bool = False) -> dict:
    """Phases 9, 12, 13, 23 and 24: the serving path end to end, through
    the kernels, its logits on a batch of CHECK_COLUMNS columns against
    the CPU's; with bf16, a bfloat16 run dir, its gathers on bfloat16 rows
    and its logits under the bfloat16 gates (bf16_logits_agree)."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.engine.export import Predictor
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    dtype = "bfloat16" if bf16 else "float32"
    name = f"{kind.upper()} ({config} config, {npoints}-point columns, batch {batch_size}, {dtype})"
    run = make_run(torch, tmp / f"run_{kind}_{config}_{npoints}_{dtype}", kind, npoints, dtype)

    infer_torch = load_script("infer_torch")
    out_dir = tmp / f"out_{kind}_{dtype}"
    args = infer_torch.parse_args([
        "--folder", str(run), "--device", "cuda", "--synthetic",
        "--synthetic_scenes", "4", "--batch_size", str(batch_size), "--out", str(out_dir),
    ])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    stats = infer_torch.infer(args)
    torch.cuda.synchronize()
    launches, bf16_launches = kernels.launch_counts(), kernels.bf16_launch_counts()
    print(f"serve {name}: launches {launches}, FPS variants {kernels.fps_kernel.variant_launches}, "
          f"bfloat16 launches {bf16_launches}", flush=True)
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check_launches(launches, kind, False, f"{name} serving", config, npoints)
    check_bf16_launches(bf16_launches, bf16, False, f"{name} serving", config)

    files = sorted(out_dir.glob("*_pred.npy"))
    if len(files) != 4:
        raise RuntimeError(f"expected 4 prediction files, found {len(files)}")
    for f in files:
        pred = np.load(f)
        labels = pred[:, 3]
        if pred.ndim != 2 or pred.shape[1] != 4 or not np.isfinite(pred).all():
            raise RuntimeError(f"{f.name}: bad prediction array {pred.shape}")
        if labels.min() < 0 or labels.max() >= 20 or not np.all(labels == np.round(labels)):
            raise RuntimeError(f"{f.name}: labels outside [0, 20)")
    print(f"serve {name}: {stats['scenes']} scenes, {stats['columns']} columns, "
          f"{stats['points']} points; predict {stats['predict_s']:.3f} s, "
          f"end to end {stats['total_s']:.3f} s; peak device memory "
          f"{stats['peak_gib']:.2f} GiB", flush=True)

    batch = serving_columns(2, npoints)[:batch_size]
    check = batch[:CHECK_COLUMNS]
    gpu = Predictor.from_run(run, batch_size=len(check), emit="logits", device="cuda")
    cpu = Predictor.from_run(run, batch_size=len(check), emit="logits", device="cpu")
    got, want = gpu.predict(check), cpu.predict(check)
    err = float(np.abs(got - want).max())
    print(f"logits {name}: card vs CPU plain path over {check.shape}: max_abs_err {err} "
          f"(max |logit| {float(np.abs(want).max())})", flush=True)
    if got.shape != (len(check), npoints, 20) or not np.isfinite(got).all():
        raise RuntimeError(f"logits of shape {got.shape} or not finite")
    if bf16:
        bf16_logits_agree(np, got, want, name)
    else:
        np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)

    labels = Predictor.from_run(run, batch_size=batch_size, device="cuda")
    labels.predict(batch)  # warm-up
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        labels.predict(batch)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    stats["steady_columns_per_s"] = len(batch) / dt
    stats["steady_points_per_s"] = len(batch) * npoints / dt
    print(f"serve {name} steady state: batch of {len(batch)} columns in {dt * 1e3:.2f} ms median "
          f"of {len(times)} (min {times[0] * 1e3:.2f}, max {times[-1] * 1e3:.2f}): "
          f"{stats['steady_columns_per_s']:.1f} columns/s, "
          f"{stats['steady_points_per_s']:.0f} points/s; serving run "
          f"{stats['columns'] / stats['predict_s']:.1f} columns/s "
          f"{stats['points'] / stats['predict_s']:.0f} points/s in predict, "
          f"{stats['columns'] / stats['total_s']:.1f} columns/s end to end", flush=True)
    stats["launches"], stats["bf16_launches"] = launches, bf16_launches
    return stats


def train_cli(torch, tmp: pathlib.Path, kind: str, config: str = "default", npoints: int = NPOINTS,
              wholescene: bool = False, batch_size: int = BATCH, trace: bool = False,
              device_store: bool = False, bf16: bool = False) -> dict:
    """Phases 10, 12, 13, 16, 20, 22 and 23: training through
    scripts/train_torch.py, through the kernels; chunked (3 steps of 32
    chunks) or whole-scene (WS_EPOCHS epochs of one update per scene); with
    trace, under --trace (check_trace); with device_store, from the
    device-resident store (its output must hold no fallback line); with
    bf16, under --bf16, its gathers and scatter-adds on bfloat16 rows.
    Returns the run's launches, peak memory and run dir."""
    import contextlib
    import io
    import math

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = (f"{kind.upper()} ({config} config, {npoints}-point columns{', whole scenes' * wholescene}"
            f"{', --trace' * trace}{', --device_store' * device_store}{', --bf16' * bf16})")
    scenes, batch, epochs = (WS_SCENES, WS_BATCH, WS_EPOCHS) if wholescene else (batch_size, batch_size, 3)
    mode = f"{'ws' if wholescene else 'chunks'}{'_trace' * trace}{'_store' * device_store}{'_bf16' * bf16}"
    trace_dir = tmp / f"trace_{kind}_{config}_{npoints}_{mode}"
    train_torch = load_script("train_torch")
    args = train_torch.parse_args([
        "--synthetic", "--synthetic_scenes", str(scenes), "--batch_size", str(batch),
        "--epoch", str(epochs), "--npoints", str(npoints), "--use_color", "--use_normal",
        "--verbose", "1", "--device", "cuda", "--tag", "chip_smoke",
        "--output_root", str(tmp / f"train_{kind}_{config}_{npoints}_{mode}"),
        *(["--use_msg"] if kind == "msg" else []), *(["--use_wholescene"] if wholescene else []),
        *(["--trace", str(trace_dir)] if trace else []), *(["--device_store"] if device_store else []),
        *(["--bf16"] if bf16 else []),
    ])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            run_dir, best = train_torch.train(args)
    finally:
        print(log.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches, bf16_launches = kernels.launch_counts(), kernels.bf16_launch_counts()
    if device_store and ("device_store disabled" in log.getvalue() or "device_store: " not in log.getvalue()):
        raise RuntimeError(f"train {name} did not train from the device-resident store")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train {name}: launches {launches}, FPS variants {kernels.fps_kernel.variant_launches}, "
          f"bfloat16 launches {bf16_launches}", flush=True)
    check_launches(launches, kind, True, f"{name} training", config, npoints)
    check_bf16_launches(bf16_launches, bf16, True, f"{name} training", config)
    for f in ("model_best.pt", "model_last.pt", "config.json", "best.txt",
              "model_last.train.pt", "tensorboard/all_scalars.json"):
        if not (run_dir / f).is_file():
            raise RuntimeError(f"the training run wrote no {f}")
    saved = json.loads((run_dir / "config.json").read_text())
    if (saved["model"]["is_msg"] != (kind == "msg") or saved["train"]["wholescene"] != wholescene
            or saved["train"]["device_store"] != device_store
            or saved["model"]["compute_dtype"] != ("bfloat16" if bf16 else "float32")):
        raise RuntimeError("the run dir's config.json records another model or mode")
    scalars = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    losses = [v for _, v in scalars["train/loss"]] + [v for _, v in scalars["val/loss"]]
    if len(scalars["train/loss"]) != epochs or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train/val losses {losses}: not {epochs} epochs of finite values")
    work = (f"{epochs} epochs of {scenes} scene updates (micro-batches of {batch} x {npoints}) and "
            f"{epochs} whole-scene validations" if wholescene
            else f"{epochs} steps of {batch} x {npoints} and {epochs} validations")
    print(f"train {name}: {work} in {took:.2f} s; losses {losses}; best val voxel mIoU "
          f"{best['voxel_miou']:.4f}; peak device memory {peak:.2f} GiB", flush=True)
    if trace:
        check_trace(trace_dir)
    return {"launches": launches, "bf16_launches": bf16_launches, "peak_gib": peak, "run_dir": run_dir}


def eval_cli(torch, tmp: pathlib.Path, kind: str) -> dict:
    """Phase 21: whole-scene evaluation through scripts/eval_torch.py and
    scripts/visualize_torch.py, through the kernels; the evaluator's
    predictions against the card's Predictor and the CPU evaluator."""
    import math

    import numpy as np

    from pointnet2_scannet_tpu_torch.engine.export import Predictor
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = f"{kind.upper()} ({EVAL_SCENES} synthetic scenes, {NPOINTS}-point columns, batch {BATCH})"
    run = make_run(torch, tmp / f"run_{kind}_eval", kind)
    eval_torch, visualize_torch = load_script("eval_torch"), load_script("visualize_torch")
    argv = ["--folder", str(run), "--device", "cuda", "--synthetic", "--synthetic_scenes", str(EVAL_SCENES),
            "--batch_size", str(BATCH)]
    launches, outs = {}, {}
    for what, entry, args in (("eval_torch.py", eval_torch.evaluate, eval_torch.parse_args(argv)),
                              ("visualize_torch.py", visualize_torch.visualize, visualize_torch.parse_args(argv))):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs[what] = entry(args)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        run_launches = kernels.launch_counts()
        print(f"{what} {name}: {took:.3f} s (model load and first calls included); launches {run_launches}, "
              f"FPS variants {kernels.fps_kernel.variant_launches}", flush=True)
        check_launches(run_launches, kind, False, f"{name} {what}")
        for k, n in run_launches.items():
            launches[k] = launches.get(k, 0) + n
    report = outs["eval_torch.py"]

    values = [report.point_acc, report.point_acc_per_class, report.voxel_acc, report.voxel_acc_per_class,
              report.voxel_cali_acc, report.point_miou, report.voxel_miou]
    tables = np.concatenate([report.per_class_point_acc, report.per_class_voxel_acc,
                             report.per_class_point_miou, report.per_class_voxel_miou])
    if len(report.scenes) != EVAL_SCENES or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values) \
            or not (np.isfinite(tables).all() and tables.min() >= 0.0 and tables.max() <= 1.0):
        raise RuntimeError(f"eval {name}: {len(report.scenes)} scenes, metrics {values} not all in [0, 1]")
    if (run / "eval_report.txt").read_text() != report.format_table():
        raise RuntimeError("eval_torch.py wrote no eval_report.txt, or another report")
    plys = sorted((run / "preds").glob("*.ply"))
    if len(plys) != EVAL_SCENES:
        raise RuntimeError(f"visualize_torch.py wrote {len(plys)} PLY files for {EVAL_SCENES} scenes")
    for ply in plys:
        lines = ply.read_text().splitlines()
        n = int(lines[2].split()[-1])
        if lines[2] != f"element vertex {n}" or len(lines) != lines.index("end_header") + 1 + n or n == 0:
            raise RuntimeError(f"{ply.name}: not an ascii PLY of its vertex count")
    print(f"eval {name}: point acc {report.point_acc:.4f}, voxel mIoU {report.voxel_miou:.4f}; "
          f"{len(plys)} PLY files", flush=True)

    # the steady evaluation, the CLI's evaluator and dataset
    _, dataset, evaluator = eval_torch.load(eval_torch.parse_args(argv))
    evaluator.evaluate(dataset, verbose=False)
    t0 = time.perf_counter()
    evaluator.evaluate(dataset, verbose=False)
    took = time.perf_counter() - t0
    forward_ms = sum(t["forward_ms"] for t in evaluator.last_timings)
    print(f"eval {name} steady: {EVAL_SCENES} scenes in {took:.3f} s, {EVAL_SCENES / took:.3f} scenes/s; "
          f"forwards {forward_ms:.2f} device ms ({forward_ms / (took * 1e3):.3f} of the wall time); "
          f"ring of {evaluator.last_ring_slots} slots", flush=True)
    for t in evaluator.last_timings:
        print(f"  {t['scene_id']}: tiling {t['tile_ms']:.2f} ms, forward {t['forward_ms']:.2f} ms (device), "
              f"metrics {t['metrics_ms']:.2f} ms", flush=True)

    # each scene's predictions: the evaluator's ring gathers and packing
    # against the Predictor's batches of the same column stacks (eval rows
    # are independent and the shapes the same: equal bit for bit), and
    # scene 0 against the CPU evaluator
    preds = evaluator.map_scenes(dataset, lambda sid, c, l, w, p: p)
    predictor = Predictor.from_run(run, batch_size=BATCH, device="cuda")
    for i, got in enumerate(preds):
        want = predictor.predict(dataset.get_scene(i)[0]).astype(np.int64)
        if not np.array_equal(got, want):
            raise RuntimeError(f"eval {name}, scene {i}: the evaluator's labels differ from the Predictor's at "
                               f"{int(np.sum(got != want))} of {got.size} points")
    _, cpu_dataset, cpu_evaluator = eval_torch.load(eval_torch.parse_args(
        [*argv[:2], "--device", "cpu", "--synthetic", "--synthetic_scenes", "1", "--batch_size", str(BATCH)]))
    [cpu] = cpu_evaluator.map_scenes(cpu_dataset, lambda sid, c, l, w, p: p)
    agree = float(np.mean(cpu == preds[0]))
    print(f"eval {name}: labels equal to the card Predictor's at every point of {len(preds)} scenes; "
          f"scene 0 card vs CPU evaluator: {agree:.6f} of {cpu.size} points agree", flush=True)
    if agree < EVAL_AGREE:
        raise RuntimeError(f"eval {name}: card and CPU evaluators agree at {agree} of the points")
    return {"launches": launches}


def check_store_launches(launches: dict, host: dict, steps: int, what: str) -> None:
    """Phase 22: a resident run launched every kernel as often as the host
    run of the same work, and d (the store gather) twice more a step."""
    want = dict(host, gather=host["gather"] + 2 * steps)
    if launches != want:
        raise RuntimeError(f"the {what} run launched {launches}, not the host run's {host} with "
                           f"2 x {steps} more gathers")


def resident_vs_host(torch) -> dict:
    """Phase 22: the chunked Solver from one seed, on the host path and with
    device_store, 2 epochs over RESIDENT_SCENES fast_scene scenes at batch 32
    x 8192, augmentation off, no validation: every step's loss equal bit for
    bit, and the resident run's launches the host run's with 2 more gathers a
    step. Returns both runs' launches."""
    from pointnet2_scannet_tpu_torch.config import DataConfig, RunConfig, TrainConfig
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.solver import Solver
    from pointnet2_scannet_tpu_torch.models import get_model
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    store = bench_torch.solver_store(RESIDENT_SCENES, 100_000)
    step = ts.train_step
    losses, launches = {}, {}
    for path in ("host", "resident"):
        def recorded(state, batch, _path=path, **kwargs):  # resident_train_step calls it too
            out = step(state, batch, **kwargs)
            losses.setdefault(_path, []).append(out["loss"])
            return out

        cfg = RunConfig(tag="chip_smoke",
                        data=DataConfig(npoints=NPOINTS, use_color=True, use_normal=True, augment=False),
                        train=TrainConfig(batch_size=BATCH, epochs=2, verbose=0, seed=0,
                                          device_store=path == "resident"))
        ds = ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
        model = get_model(20, is_msg=False, input_channels=6, generator=torch.Generator().manual_seed(0))
        ts.train_step = recorded
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out:
                solver = Solver(model, ds, None, cfg, out, device="cuda")
                if solver.device_store != (path == "resident"):
                    raise RuntimeError(f"the {path} Solver ran with device_store {solver.device_store}")
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                solver()
                torch.cuda.synchronize()
                launches[path] = kernels.launch_counts()
                check_launches(launches[path], "ssg", True, f"{path} Solver")
        finally:
            ts.train_step = step
        del solver
    host, res = (torch.stack(losses[p]).cpu() for p in ("host", "resident"))
    steps = len(host)
    print(f"Solver host path vs device store (SSG, {RESIDENT_SCENES} scenes, 2 epochs of "
          f"{steps // 2} steps, augmentation off): losses {host.tolist()} vs {res.tolist()}; "
          f"launches {launches['host']} vs {launches['resident']}", flush=True)
    if len(res) != steps or steps != 2 * (RESIDENT_SCENES // BATCH) or not torch.equal(host, res):
        raise RuntimeError("the resident Solver's per-step losses differ from the host path's")
    if not bool(torch.isfinite(host).all()):
        raise RuntimeError(f"non-finite losses {host.tolist()}")
    check_store_launches(launches["resident"], launches["host"], steps, "resident Solver")
    return {"launches": {k: launches["host"][k] + launches["resident"][k] for k in launches["host"]}}


def check_store_gather(torch, tally) -> None:
    """Phase 22: d's store gather (data/resident.materialize_batch's two
    launches, points and labels) at the bench_torch.py Solver cell's store,
    on the rows of one resident batch: bit for bit against gather_plain,
    timed beside torch.index_select on an int64 index made beforehand. Bytes:
    the distinct store rows read (40 bytes each), the rows, the output."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import ResidentBatchLoader, flatten_store
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga

    n_scenes, n_points, batch, npoints, _ = bench_torch.SIZES["cuda"]["solver"]
    store = bench_torch.solver_store(n_scenes, n_points)
    cfg = DataConfig(npoints=npoints, use_color=True, use_normal=True)
    ds = ChunkedSceneDataset(store, cfg, phase="train", seed=0, resident=True)
    ds.generate_chunks()
    idx = next(iter(ResidentBatchLoader(ds, batch)))["idx"]
    pts, labels = flatten_store(store, cfg)
    del store, ds
    src = torch.from_numpy(pts).to("cuda").unsqueeze(0)
    lab = torch.from_numpy(labels).to("cuda").view(1, -1, 1)
    del pts, labels
    rows = torch.from_numpy(idx).to("cuda").view(1, -1)
    index = rows.view(-1).long()
    (_, t, c), j = src.shape, rows.shape[1]
    check(torch, tally, "store", f"gather store ({t} rows x {c} f32 + labels i32) x {batch} x {npoints} rows",
          lambda: (ga.gather_cuda(src, rows), ga.gather_cuda(lab, rows)),
          lambda: (ga.gather_plain(src, rows), ga.gather_plain(lab, rows)),
          4 * (distinct_rows(rows) * (c + 1) + j + j * (c + 1)), 0,
          library_fn=lambda: (torch.index_select(src[0], 0, index), torch.index_select(lab.view(-1), 0, index)))
    del src, lab
    torch.cuda.empty_cache()


# the hand-written kernels (csrc/, each in an anonymous namespace) of an SSG
# train step at 8192 points: FPS, the ball query's resident route, the row
# gather, 3-NN and the scatter-add's block route
TRACE_KERNELS = {"fps_kernel", "ball_query_resident_kernel", "gather_kernel", "three_nn_kernel", "block_kernel"}


def check_trace(trace_dir: pathlib.Path) -> None:
    """Phase 20: --trace wrote one Chrome trace file, whose kernel events
    name FPS and the other hand-written kernels of the SSG step."""
    import collections
    import re

    files = sorted(trace_dir.iterdir()) if trace_dir.is_dir() else []
    if len(files) != 1 or not files[0].name.endswith(".json"):
        raise RuntimeError(f"--trace wrote {[f.name for f in files]}, not one trace file")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    ours = collections.Counter(m.group(1) for n in kernels if (m := re.match(r"void \(anonymous namespace\)::(\w+)", n)))
    print(f"trace {files[0].name}: {files[0].stat().st_size / 2**20:.1f} MiB, {len(events)} events, "
          f"{len(kernels)} kernel events; hand-written kernels {dict(ours)}", flush=True)
    if not TRACE_KERNELS <= set(ours):
        raise RuntimeError(f"the trace names no kernel {sorted(TRACE_KERNELS - set(ours))}")


def print_columns() -> None:
    """Phase 16's column counts: per training scene, its columns, its
    micro-batches of WS_BATCH and the padded rows of its last one."""
    ds = bench_torch.wholescene_dataset(WS_SCENES, NPOINTS)
    cols = [ds.get_scene(i)[0].shape[0] for i in range(len(ds))]
    print(f"whole scenes: columns per training scene {cols}; micro-batches of {WS_BATCH}: "
          f"{[-(-c // WS_BATCH) for c in cols]}, padded rows {[-c % WS_BATCH for c in cols]}", flush=True)
    if not any(c % WS_BATCH for c in cols) or not all(c > WS_BATCH for c in cols):
        raise RuntimeError("the whole-scene run would have no padded or no multi-micro-batch scene")


def train_batch(torch, n: int, device, npoints: int = NPOINTS, input_channels: int = 6):
    """A train batch of n full-width chunks of synthetic scenes, on device:
    xyz + colour + normal (6 input channels), or the mv131 recipe's xyz +
    normal + label-correlated multiview features (131)."""
    from pointnet2_scannet_tpu_torch.config import DataConfig
    from pointnet2_scannet_tpu_torch.data import make_synthetic_store
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.data.pipeline import BatchLoader, to_device
    from pointnet2_scannet_tpu_torch.data.synthetic import attach_label_multiview

    mv = input_channels == MV131
    cfg = DataConfig(npoints=npoints, use_color=not mv, use_normal=True, use_multiview=mv)
    store = make_synthetic_store(n, seed=0)
    if mv:
        attach_label_multiview(store)
    ds = ChunkedSceneDataset(store, cfg, phase="train", seed=0)
    ds.generate_chunks()
    return to_device(next(iter(BatchLoader(ds, n, drop_last=True))), device)


def grad_errors(got: dict, want: dict) -> list:
    """Per-tensor relative L2 error of gradients, sorted, worst first."""
    return sorted(((float((got[k].double() - w).norm() / w.norm()), k) for k, w in want.items()),
                  reverse=True)


def all_l2(got: dict, want: dict) -> float:
    """Relative L2 error of gradients over all parameters together."""
    return float(sum(((got[k].double() - w) ** 2).sum() for k, w in want.items()).sqrt()
                 / sum((w.double() ** 2).sum() for w in want.values()).sqrt())


# the CPU steps (float64, float32) of train_step_card_vs_cpu by model kind,
# column size, input channels and interpolation form, shared by phases 11
# and 12: on the CPU the MXU route's plain versions compute the default
# route's functions
CPU_STEPS: dict = {}


def train_step_card_vs_cpu(torch, kind: str, config: str = "default", npoints: int = NPOINTS,
                           input_channels: int = 6) -> None:
    """Phases 11, 12, 18 and 26: one train step from the same weights on the
    card and on the CPU (float32 both, and float64 on the CPU as the
    reference), Dropout off; the card's step launches its route's kernels
    and no other, and at the mv131 recipe's 131 input channels takes the
    pregather at SA1 (1024 centroids) and at no other level."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops import tuning

    # the interpolation form changes the CPU step's rounding; the MXU route does not
    out = CPU_STEPS.setdefault((kind, npoints, input_channels, tuning.interpolate_route()), {})
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        if (device, dtype) in out and device == "cpu":
            continue
        state = bench_torch.fresh_state(kind, device, 0.0, input_channels=input_channels)
        state.model.to(dtype)
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in train_batch(torch, 2, device, npoints, input_channels).items()}
        if device == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tuning.reset_route_counts()
        res = ts.train_step(state, batch, num_classes=20)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            pregather = {k: n for k, n in tuning.route_counts.items() if k[0] == "pregather"}
        m = state.model
        out[(device, dtype)] = (
            float(res["loss"]), {k: p.grad.cpu() for k, p in m.named_parameters()},
            {k: b.cpu() for k, b in m.named_buffers() if b.is_floating_point()},
        )
    ref = out[("cpu", torch.float64)][1]
    (cpu_loss, cpu_g, cpu_b), (gpu_loss, gpu_g, gpu_b) = (
        out[("cpu", torch.float32)], out[("cuda", torch.float32)])
    direct, card, cpu = grad_errors(gpu_g, cpu_g), grad_errors(gpu_g, ref), grad_errors(cpu_g, ref)
    med = len(card) // 2
    bn_err = max(float((gpu_b[k] - b).abs().max()) for k, b in cpu_b.items())
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    name = f"{kind.upper()} ({config} config, 2 x {npoints}, {input_channels} input channels)"
    print(f"train step {name} on the card: launches {launches}, pregathers {pregather}", flush=True)
    check_launches(launches, kind, True, f"train step {name}", config, npoints)
    if input_channels == MV131 and kind == "ssg" and pregather != {("pregather", 1024): 1}:
        raise RuntimeError(f"the mv131 train step took the pregather at {pregather}, not at SA1 alone")
    print(f"train step {name} card vs CPU: loss {gpu_loss} vs {cpu_loss} "
          f"(rel {loss_err:.2e}); BatchNorm stats max abs err {bn_err:.2e}; gradients, per-tensor "
          f"relative L2 over {len(card)} tensors, worst / median: card vs CPU float32 "
          f"{direct[0][0]:.2e} ({direct[0][1]}) / {direct[med][0]:.2e}; vs CPU float64: card "
          f"{card[0][0]:.2e} ({card[0][1]}) / {card[med][0]:.2e}, CPU float32 {cpu[0][0]:.2e} "
          f"({cpu[0][1]}) / {cpu[med][0]:.2e}", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise RuntimeError("train step: the card's loss disagrees with the CPU's")
    if not (card[0][0] <= TRAIN_GRAD_VS_CPU * cpu[0][0]
            and card[med][0] <= TRAIN_GRAD_VS_CPU * cpu[med][0]):
        raise RuntimeError("train step: the card's gradients are further from the float64 "
                           "reference than the CPU's float32 gradients allow")
    for k, b in cpu_b.items():
        torch.testing.assert_close(gpu_b[k], b, rtol=TRAIN_BN_TOL, atol=TRAIN_BN_TOL)


def padded_kernels(torch, xyz, kind: str) -> None:
    """Phase 17: FPS, the ball query of the model's kind and 3-NN on the
    level clouds of a padded micro-batch (xyz (B, N, 3), zero rows
    included), bit for bit against their plain versions."""
    from pointnet2_scannet_tpu_torch.models import msg_spec, ssg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import (
        ball_query_kernel as bq,
        ball_query_multi_kernel as bqm,
        fps_kernel as fps,
        gather_kernel as ga,
        three_nn_kernel as nn3,
    )

    spec = (msg_spec if kind == "msg" else ssg_spec)(20, 6)
    pairs = []
    for k, npoint in enumerate(spec.npoints):
        pairs.append((f"fps {xyz.shape[1]}->{npoint}", fps.furthest_point_sample_cuda(xyz, npoint),
                      fps.furthest_point_sample_plain(xyz, npoint)))
        q = ga.gather_plain(xyz, pairs[-1][2]).contiguous()
        radii, ks = spec.radii[k], spec.nsamples[k]
        if len(radii) == 2:
            got, want = bqm.ball_query_multi_cuda(radii, ks, xyz, q), bqm.ball_query_multi_plain(radii, ks, xyz, q)
        else:
            got, want = bq.ball_query_cuda(radii[0], ks[0], xyz, q), bq.ball_query_plain(radii[0], ks[0], xyz, q)
        pairs += [(f"ball query r={radii} level {k}", g, w) for g, w in zip(got, want)]
        got, want = nn3.three_nn_cuda(xyz, q), nn3.three_nn_plain(xyz, q)
        pairs += [(f"three_nn level {k}", g, w) for g, w in zip(got, want)]
        xyz = q
    differ = [label for label, g, w in pairs if not torch.equal(g, w)]
    if differ:
        raise RuntimeError(f"on the padded micro-batch, kernels differ from their plain versions: {differ}")


def wholescene_card_vs_cpu(torch, kind: str) -> None:
    """Phase 17: one scene's accumulated update (WS_CHECK_COLUMNS columns at
    micro-batch WS_CHECK_BATCH, the last one padded, Dropout off) on the card
    and on the CPU (float32 both, float64 on the CPU as the reference); the
    kernels of the path on the padded micro-batch against their plain
    versions."""
    from pointnet2_scannet_tpu_torch.data.pipeline import to_device
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.solver import _SceneBatchIterator

    scene = bench_torch.wholescene_dataset(1, NPOINTS).get_scene(0)
    feats, labels, weights = (a[:WS_CHECK_COLUMNS] for a in scene)
    micro = list(_SceneBatchIterator(None, WS_CHECK_BATCH).micro_batches(feats, labels, weights))
    masks = [mb["row_mask"].tolist() for mb in micro]
    padded = to_device(micro[-1], "cuda")
    padded_kernels(torch, padded["points"][..., :3].contiguous(), kind)
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        state = bench_torch.fresh_state(kind, device, 0.0)
        state.model.to(dtype)
        loss_sum = count = 0.0
        for mb in micro:
            batch = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in to_device(mb, device).items()}
            res = ts.grad_accum_step(state, batch, num_classes=20)
            loss_sum, count = loss_sum + float(res["loss_sum"]), count + float(res["count"])
        m = state.model
        out[(device, dtype)] = (
            loss_sum, count, {k: p.grad.cpu() / count for k, p in m.named_parameters()},
            {k: b.cpu() for k, b in m.named_buffers() if b.is_floating_point()},
        )
        ts.apply_accumulated(state, count)
        if state.step != 1 or not all(bool(torch.isfinite(p).all()) for p in m.parameters()):
            raise RuntimeError("the accumulated update did not take one finite step")
    ref = out[("cpu", torch.float64)][2]
    (cpu_loss, cpu_n, cpu_g, cpu_b), (gpu_loss, gpu_n, gpu_g, gpu_b) = (
        out[("cpu", torch.float32)], out[("cuda", torch.float32)])
    card, cpu = grad_errors(gpu_g, ref), grad_errors(cpu_g, ref)
    med = len(card) // 2
    bn_err = max(float((gpu_b[k] - b).abs().max()) for k, b in cpu_b.items())
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"whole-scene update {kind.upper()} card vs CPU ({WS_CHECK_COLUMNS} x {NPOINTS} columns, "
          f"micro-batch row masks {masks}): loss sum {gpu_loss} vs {cpu_loss} (rel {loss_err:.2e}); "
          f"points {gpu_n:.0f} vs {cpu_n:.0f}; BatchNorm stats max abs err {bn_err:.2e}; gradients, "
          f"per-tensor relative L2 vs CPU float64, worst / median: card {card[0][0]:.2e} ({card[0][1]}) / "
          f"{card[med][0]:.2e}, CPU float32 {cpu[0][0]:.2e} ({cpu[0][1]}) / {cpu[med][0]:.2e}; "
          f"kernels on the padded micro-batch equal to plain", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and gpu_n == cpu_n == WS_CHECK_COLUMNS * NPOINTS):
        raise RuntimeError("whole-scene update: the card's loss sum or point count disagrees with the CPU's")
    if not (card[0][0] <= TRAIN_GRAD_VS_CPU * cpu[0][0]
            and card[med][0] <= TRAIN_GRAD_VS_CPU * cpu[med][0]):
        raise RuntimeError("whole-scene update: the card's gradients are further from the float64 "
                           "reference than the CPU's float32 gradients allow")
    for k, b in cpu_b.items():
        torch.testing.assert_close(gpu_b[k], b, rtol=TRAIN_BN_TOL, atol=TRAIN_BN_TOL)


def wholescene_time(kind: str) -> dict:
    """Phase 17: the steady whole-scene update of one synthetic scene at
    micro-batch BATCH, timed by bench_torch.wholescene_time (its cell)."""
    ws = bench_torch.wholescene_time(kind, "cuda", BATCH, NPOINTS)
    times = ws["times"]
    ms = times[len(times) // 2]
    pps = ws["real"] * NPOINTS / (ms / 1e3)
    print(f"whole-scene update {kind.upper()} steady state: one scene of {ws['real']} real and "
          f"{ws['padded']} padded rows ({ws['micro_batches']} micro-batch(es) of {BATCH} x {NPOINTS}) in "
          f"{ms:.2f} ms median of {len(times)} (min {times[0]:.2f}, max {times[-1]:.2f}): {pps:.0f} real "
          f"points/s; host tiling of the scene {ws['tile_ms']:.1f} ms", flush=True)
    return {"ms": ms, "points_per_s": pps}


def train_step_repeat_and_time(torch, kind: str, config: str = "default", batch_size: int = BATCH,
                               npoints: int = NPOINTS, dtype=None, input_channels: int = 6) -> dict:
    """Phases 11, 12, 23 and 26: two identical steps on the card give the
    same bits and launch the kernels of the configuration's path (in compute
    dtype dtype, None: float32; with input_channels feature channels); then
    the warm step at batch 32, timed with CUDA events."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = (f"{kind.upper()} ({config} config, {batch_size} x {npoints}{', bfloat16' * (dtype is not None)}"
            f"{f', {input_channels} input channels' * (input_channels != 6)})")
    batch = train_batch(torch, batch_size, "cuda", npoints, input_channels)
    states = []
    kernels.reset_launch_counts()
    for _ in range(2):
        state = bench_torch.fresh_state(kind, "cuda", 0.5, dtype=dtype, input_channels=input_channels)
        ts.train_step(state, batch, num_classes=20)
        states.append(state.model.state_dict())
    check_launches(kernels.launch_counts(), kind, True, f"{name} determinism", config, npoints)
    check_bf16_launches(kernels.bf16_launch_counts(), dtype is not None, True, f"{name} determinism", config)
    differ = [k for k, v in states[0].items() if not torch.equal(states[1][k], v)]
    print(f"train step {name} determinism (Dropout 0.5): {len(states[0])} tensors, "
          f"{len(differ)} differ", flush=True)
    if differ:
        raise RuntimeError(f"two identical train steps on the card differ in {differ[:5]}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    times = bench_torch.timed_windows(
        lambda: losses.append(ts.train_step(state, batch, num_classes=20)["loss"]), "cuda", 1, 10, 3)
    if not bool(torch.isfinite(losses[-1])):
        raise RuntimeError("the steady-state train step's loss is not finite")
    ms = times[len(times) // 2]
    pps = batch_size * npoints / (ms / 1e3)
    print(f"train {name} steady state: step of {batch_size} x {npoints} in {ms:.2f} ms median of "
          f"{len(times)} (min {times[0]:.2f}, max {times[-1]:.2f}): {pps:.0f} points/s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return {"ms": ms, "points_per_s": pps}


def time_configs(torch) -> None:
    """Phase 12: the SSG model's steady serving forward and train step at
    32 x 8192 under the default configuration and P1's, timed with CUDA
    events in the order default, P1, P1, default; the eval logits of the
    two must agree."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    batch = train_batch(torch, BATCH, "cuda")
    state = bench_torch.fresh_state("ssg", "cuda", 0.5)
    model = state.model

    def forward():
        model.eval()
        with torch.inference_mode():
            return model(batch["points"])

    logits = {}
    with switches(**MXU_CONFIG):
        logits["p1"] = forward()
    logits["default"] = forward()
    err = float((logits["p1"] - logits["default"]).abs().max())
    if not torch.equal(logits["p1"], logits["default"]):
        raise RuntimeError(f"SSG eval logits differ between the configurations ({err})")
    times = {(c, what): [] for c in ("default", "p1") for what in ("serve forward", "train step")}
    for config in ("default", "p1", "p1", "default"):
        with switches(**(MXU_CONFIG if config == "p1" else {})):
            times[(config, "serve forward")].append(cuda_ms(forward, torch))
            times[(config, "train step")].append(
                cuda_ms(lambda: ts.train_step(state, batch, num_classes=20), torch))
    print(f"configurations SSG (B={BATCH} x {NPOINTS}): eval logits default vs P1 equal; "
          + "; ".join(f"{what} {c} " + " / ".join(f"{t:.3f}" for t in ms) + " ms"
                      for (c, what), ms in times.items()), flush=True)


def time_configs_bf16(torch) -> None:
    """Phase 24: the SSG model's steady serving forward and train step at
    32 x 8192 in bfloat16 under the default configuration and P1's, and in
    float32 under P1's, each the median of 5 windows of 5 calls between
    CUDA events, in the order default, P1, P1, default."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    batch = train_batch(torch, BATCH, "cuda")
    states = {"bfloat16": bench_torch.fresh_state("ssg", "cuda", 0.5, dtype=torch.bfloat16),
              "float32": bench_torch.fresh_state("ssg", "cuda", 0.5)}

    def forward(model):
        model.eval()
        with torch.inference_mode():
            return model(batch["points"])

    def median_ms(fn) -> float:
        times = bench_torch.timed_windows(fn, "cuda", 5, 5, 3)
        return times[len(times) // 2]

    times = {}
    for config in ("default", "p1", "p1", "default"):
        with switches(**(MXU_CONFIG if config == "p1" else {})):
            for dtype in ("bfloat16", "float32") if config == "p1" else ("bfloat16",):
                state = states[dtype]
                times.setdefault((dtype, config, "serve forward"), []).append(
                    median_ms(lambda: forward(state.model)))
                times.setdefault((dtype, config, "train step"), []).append(
                    median_ms(lambda: ts.train_step(state, batch, num_classes=20)))
    print(f"configurations SSG bfloat16 (B={BATCH} x {NPOINTS}), order default, P1, P1, default: "
          + "; ".join(f"{what} {dtype} {c} " + " / ".join(f"{t:.3f}" for t in ms) + " ms"
                      for (dtype, c, what), ms in times.items()), flush=True)


def serve_forward_bf16(torch, tmp: pathlib.Path, kind: str) -> dict:
    """Phase 24: one serving forward (a batch of 32) of a bfloat16 run dir
    of the model under P1 (the caller's switches) through Predictor,
    launching its path's kernels (e on bfloat16 rows) and no other; its
    first CHECK_COLUMNS columns' logits against the CPU's under phase 23's
    logit and label gates."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.engine.export import Predictor
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = f"{kind.upper()} (mxu config, {NPOINTS}-point columns, batch {BATCH}, bfloat16) serving forward"
    run = make_run(torch, tmp / f"run_{kind}_forward_bf16", kind, compute_dtype="bfloat16")
    batch = serving_columns(2)[:BATCH]
    gpu = Predictor.from_run(run, batch_size=BATCH, emit="logits", device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = gpu.predict(batch)
    torch.cuda.synchronize()
    launches, bf16_launches = kernels.launch_counts(), kernels.bf16_launch_counts()
    print(f"{name}: launches {launches}, bfloat16 launches {bf16_launches}", flush=True)
    check_launches(launches, kind, False, name, "mxu")
    check_bf16_launches(bf16_launches, True, False, name, "mxu")
    check = batch[:CHECK_COLUMNS]
    want = Predictor.from_run(run, batch_size=len(check), emit="logits", device="cpu").predict(check)
    if got.shape != (len(batch), NPOINTS, 20) or not np.isfinite(got).all():
        raise RuntimeError(f"{name}: logits of shape {got.shape} or not finite")
    bf16_logits_agree(np, got[:len(check)], want, name)
    return {"launches": launches, "bf16_launches": bf16_launches}


def bench_gather(torch) -> dict:
    """Phase 14: scripts/bench_gather_torch.py at its shapes, a few calls of
    each lowering; returns its launch counts."""
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    bench = load_script("bench_gather_torch")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    bench.run("cuda", reps=5)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"bench_gather_torch: launches {launches}", flush=True)
    want = {"gather", "gather_smem", "gather_split", "scatter_add", "scatter_smem"}
    missing = sorted(k for k in want if launches[k] == 0)
    stray = sorted(k for k, n in launches.items() if k not in want and n)
    if missing or stray:
        raise RuntimeError(f"bench_gather_torch launched no {missing} kernel, or launched {stray}")
    return launches


def bench_fused(torch) -> dict:
    """Phase 15: scripts/bench_fused_sa_torch.py at its shape, a few calls of
    each; returns its launch counts."""
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    bench = load_script("bench_fused_sa_torch")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    bench.run("cuda", reps=5)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"bench_fused_sa_torch: launches {launches}", flush=True)
    want = {"gather", "fused_gather_mm"}
    missing = sorted(k for k in want if launches[k] == 0)
    stray = sorted(k for k, n in launches.items() if k not in want and n)
    if missing or stray:
        raise RuntimeError(f"bench_fused_sa_torch launched no {missing} kernel, or launched {stray}")
    return launches


BENCH_KERNELS = {"furthest_point_sample", "ball_query", "ball_query_multi", "gather", "three_nn", "scatter_add"}
# bench.py's bfloat16 fields (bench.py:219-270) in bench_torch.py's row
BENCH_BF16 = ("step_ms_bf16", "step_ms_bf16_min", "step_ms_bf16_max", "step_ms_bf16_per_dispatch",
              "ssg_bf16_points_per_sec", "msg_bf16_points_per_sec", "msg_bf16_step_ms_min",
              "msg_bf16_step_ms_max", "mfu_bf16")


def bench(torch) -> dict:
    """Phase 19: bench_torch.run("cuda"), whose JSON line is printed here;
    every cell must give finite positive numbers, and the run must launch
    the default route's kernels (BENCH_KERNELS) and no other. Returns its
    launch counts."""
    import math

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    row = bench_torch.run("cuda")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(json.dumps(row), flush=True)
    print(f"bench_torch: launches {launches}", flush=True)
    missing = sorted(k for k in BENCH_KERNELS if launches[k] == 0)
    stray = sorted(k for k, n in launches.items() if k not in BENCH_KERNELS and n)
    if missing or stray:
        raise RuntimeError(f"bench_torch launched no {missing} kernel, or launched {stray}")
    numbers = {k: v for k, v in row.items() if isinstance(v, float)}
    if row["unported"] or not set(BENCH_BF16) <= set(numbers):
        raise RuntimeError(f"bench_torch's row lacks bfloat16 fields {sorted(set(BENCH_BF16) - set(numbers))} "
                           f"or leaves {row['unported']} unported")
    epochs = [v for k, vs in row.items() if k.startswith("solver_") and isinstance(vs, list) for v in vs]
    bad = sorted(k for k, v in numbers.items() if not (math.isfinite(v) and v > 0))
    solver = {f"solver_points_per_sec_{p}" for p in ("host", "resident")} | {"solver_store_upload_s"}
    if (bad or row["metric"] != bench_torch.METRIC or len(numbers) < 16 or not solver <= set(numbers)
            or not all(math.isfinite(v) and v > 0 for v in epochs)):
        raise RuntimeError(f"bench_torch's row has no finite positive {bad}: {row}")
    return launches


def check_bf16_launches(bf16_launches: dict, bf16: bool, training: bool, what: str,
                        config: str = "default") -> None:
    """Phases 23 and 24: a bfloat16 run launched d (and, training, h) on
    bfloat16 rows, and under P1 ("mxu") e (and, training, f) too; g never
    (no model path takes it); a float32 run launched none of them on
    bfloat16 rows."""
    mxu = config == "mxu"
    want = {"gather": bf16, "scatter_add": bf16 and training, "gather_smem": bf16 and mxu,
            "scatter_smem": bf16 and mxu and training, "gather_split": False}
    got = {k: n > 0 for k, n in bf16_launches.items()}
    if got != want:
        raise RuntimeError(f"the {what} run launched {bf16_launches} on bfloat16 rows")


def bf16_logits_agree(np, got, want, what: str) -> None:
    """Phase 23's serving gate: logits within BF16_LOGIT_SCALE_TOL of the
    largest |logit| and labels equal at BF16_LABEL_AGREE of the points, a
    point counting where either label is a maximum of the other side's
    logits (bfloat16 ties)."""
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    gl, wl = got.argmax(-1), want.argmax(-1)
    tie = (np.take_along_axis(want, gl[..., None], -1)[..., 0] == want.max(-1)) | \
          (np.take_along_axis(got, wl[..., None], -1)[..., 0] == got.max(-1))
    agree, equal = float(np.mean((gl == wl) | tie)), float(np.mean(gl == wl))
    print(f"logits {what}: card vs CPU bfloat16, max |diff| / max |logit| {err:.4f} (bound "
          f"{BF16_LOGIT_SCALE_TOL}); labels equal at {equal:.6f} of the points, {agree:.6f} counting ties "
          f"(bound {BF16_LABEL_AGREE})", flush=True)
    if not (err <= BF16_LOGIT_SCALE_TOL and agree >= BF16_LABEL_AGREE):
        raise RuntimeError(f"{what}: the card's bfloat16 logits or labels disagree with the CPU's")


def check_bf16_kernels(torch, tallies, xyz, multi_idx) -> None:
    """Phase 23: d on bfloat16 rows at every gather of the SSG and MSG
    bfloat16 models in training (the packed grouping payloads, 6 + C wide,
    at each level, and the FP interpolations) and at SA1's odd payload of a
    3-channel input (6 + 3, the 2-byte route), bit for bit against
    gather_plain; h on bfloat16 cotangents at every gather gradient of
    those train steps and at phase 4's N = 65535 skewed row, bit for bit
    against the plain version on CPU copies; each timed beside its library
    call and bound."""
    from pointnet2_scannet_tpu_torch.models import msg_spec
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(23)

    def rows(n, c):
        return torch.randn((BATCH, n, c), generator=gen, device="cuda").to(bf16)

    tally = tallies[ga.NAME]
    spec = msg_spec(20, 6)
    backward = {"ssg": [], "msg": []}
    for k, (n_in, n_out, radius, c) in enumerate(LEVELS):
        x, q = xyz[k], xyz[k + 1]
        nidx = bq.ball_query_cuda(radius, NSAMPLE, x, q).reshape(BATCH, -1)
        gather_check(torch, tally, "ssg bf16", f"gather bf16 packed grouping ({BATCH},{n_in},{BF16_XYZ + c})"
                     f"x{nidx.shape[1]}", rows(n_in, BF16_XYZ + c), nidx)
        if k == 0:
            gather_check(torch, tally, "odd bf16", f"gather bf16 packed grouping, 3-channel input "
                         f"({BATCH},{n_in},{BF16_XYZ + BF16_ODD_C})x{nidx.shape[1]}",
                         rows(n_in, BF16_XYZ + BF16_ODD_C), nidx)
        else:
            backward["ssg"].append((f"SA{k + 1} packed grouping", nidx, n_in, BF16_XYZ + c))
        nn_idx = nn3.three_nn_cuda(x, q)[1].reshape(BATCH, -1)
        gather_check(torch, tally, "ssg bf16", f"gather bf16 FP{k} interpolation ({BATCH},{n_out},"
                     f"{FP_CHANNELS[k]})x{nn_idx.shape[1]}", rows(n_out, FP_CHANNELS[k]), nn_idx)
        backward["ssg"].append((f"FP{k} interpolation", nn_idx, n_out, FP_CHANNELS[k]))
        c_msg = spec.skip_channels[k]
        for s in range(2):
            idx = multi_idx[k][s].reshape(BATCH, -1)
            gather_check(torch, tally, "msg bf16", f"gather bf16 MSG SA{k + 1} scale {s} packed grouping "
                         f"({BATCH},{n_in},{BF16_XYZ + c_msg})x{idx.shape[1]}", rows(n_in, BF16_XYZ + c_msg), idx)
            if k > 0:
                backward["msg"].append((f"SA{k + 1} scale {s} packed grouping", idx, n_in, BF16_XYZ + c_msg))
        c_fp = spec.sa_out_channels[-1] if k == len(spec.fp_mlps) - 1 else spec.fp_mlps[k + 1][-1]
        gather_check(torch, tally, "msg bf16", f"gather bf16 MSG FP{k} interpolation ({BATCH},{n_out},{c_fp})"
                     f"x{nn_idx.shape[1]}", rows(n_out, c_fp), nn_idx)
        backward["msg"].append((f"FP{k} interpolation", nn_idx, n_out, c_fp))
    for kind, shapes in backward.items():
        check_scatter(torch, tallies["scatter_add"], f"{kind} bf16", shapes, bf16)
    check_scatter(torch, tallies["scatter_add"], "skew bf16", skewed_row(torch), bf16)


def check_p1_bf16_kernels(torch, tallies, xyz, multi_idx) -> None:
    """Phase 24: e on bfloat16 rows at every gather that the SSG and MSG
    bfloat16 train steps route to it under P1 (the packed [xyz_hi | xyz_lo
    | features] groupings, listed from LEVELS and the MSG spec through
    gather_route) and at bench_gather's shapes (C 9: 2-byte words), g on
    bfloat16 rows at those, each bit for bit against its plain version;
    f on bfloat16 cotangents at those train steps' grouping gradients, at
    bench_gather's shapes and at phase 4's skewed row, bit for bit against
    its plain version's bfloat16 branch on CPU copies; each timed beside
    its counterpart, library call and bound. The tallies are e's, f's and
    g's bfloat16 rows."""
    from pointnet2_scannet_tpu_torch.models import msg_spec
    from pointnet2_scannet_tpu_torch.ops import tuning
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_split_kernel as gsp

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(24)

    def rows(n, c):
        return torch.randn((BATCH, n, c), generator=gen, device="cuda").to(bf16)

    spec = msg_spec(20, 6)
    groupings = {"ssg": [], "msg": []}
    for k, (n_in, _, radius, c) in enumerate(LEVELS):
        x, q = xyz[k], xyz[k + 1]
        groupings["ssg"].append((f"SA{k + 1}", bq.ball_query_cuda(radius, NSAMPLE, x, q).reshape(BATCH, -1),
                                 n_in, BF16_XYZ + c))
        for s in range(2):
            groupings["msg"].append((f"SA{k + 1} scale {s}", multi_idx[k][s].reshape(BATCH, -1), n_in,
                                     BF16_XYZ + spec.skip_channels[k]))
    with switches(**MXU_CONFIG):
        for kind, shapes in groupings.items():
            backward = []
            for label, idx, n, width in shapes:
                if tuning.gather_route(n, idx.shape[1], width, bf16) != "mxu":
                    continue
                smem_gather_check(torch, tallies["gather_smem"], f"p1 {kind} bf16",
                                  f"gather_smem bf16 P1 {kind.upper()} {label} packed grouping "
                                  f"({BATCH},{n},{width})x{idx.shape[1]}", rows(n, width), idx,
                                  gs.gather_smem_cuda, gs.gather_smem_plain)
                if not label.startswith("SA1"):  # SA1 groups input data: no gradient
                    backward.append((f"{label} packed grouping", idx, n, width))
            check_scatter(torch, tallies["scatter_smem"], f"p1 {kind} bf16", backward, bf16)
    backward = []
    for c in BENCH_C:
        src = rows(BENCH_N, c)
        idx = torch.randint(0, BENCH_N, (BATCH, BENCH_J), generator=gen, device="cuda", dtype=torch.int32)
        shape = f"({BATCH},{BENCH_N},{c})x{BENCH_J}"
        smem_gather_check(torch, tallies["gather_smem"], "bench bf16", f"gather_smem bf16 bench {shape}", src,
                          idx, gs.gather_smem_cuda, gs.gather_smem_plain)
        smem_gather_check(torch, tallies["gather_split"], "bench bf16", f"gather_split bf16 bench {shape}", src,
                          idx, gsp.gather_split_cuda, gsp.gather_split_plain)
        backward.append((f"bench C={c:02d}", idx, BENCH_N, c))
    check_scatter(torch, tallies["scatter_smem"], "bench bf16", backward, bf16)
    check_scatter(torch, tallies["scatter_smem"], "skew bf16", skewed_row(torch), bf16)


@contextlib.contextmanager
def scaled(module, name: str, scale: float):
    """Phases 23 and 24's negative controls: a scatter-add's wrapper (h's
    scatter_add_cuda, f's scatter_smem_cuda) returns its output times scale
    (0.5: halved, 0.0: zeroed) for the duration."""
    wrapper = getattr(module, name)
    setattr(module, name, lambda idx, g, n: wrapper(idx, g, n) * scale)
    try:
        yield
    finally:
        setattr(module, name, wrapper)


# the float64 CPU step's gradients of each model kind, shared by phases 23
# and 24: its gathers and scatter-adds compute the same float64 function on
# either configuration's routes
F64_GRADS: dict = {}


def train_step_card_vs_cpu_bf16(torch, kind: str, config: str = "default") -> None:
    """Phases 23 and 24: one bfloat16 train step from the same weights on
    the card and on the CPU (2 full-width columns, Dropout off), and a
    float64 CPU step of those weights as the reference: the loss within
    BF16_LOSS_RTOL of the CPU's; the card's gradients (over all parameters
    and at the median tensor) at most BF16_GRAD_VS_CPU times as far from
    the float64 ones as the CPU's bfloat16 gradients are, and at the median
    tensor no further from the CPU's bfloat16 gradients than those are from
    the float64 ones over all parameters; the parameters stay float32. The
    same gates must refuse the card's step with the grouping gradients'
    kernel's output halved and zeroed: h's under the default configuration,
    f's under P1 ("mxu"). Under P1 the card's step must launch f on
    bfloat16 rows, and a fourth gate holds each of f's outputs in the step,
    as the step received it, bit for bit against f's plain version on CPU
    copies of that launch's inputs: f feeds only the SA1 and SA2 parameters,
    so the distances over all parameters may pass a halved f (the note at
    BF16_GRAD_VS_CPU)."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    def step(device, dtype, record=None):
        state = bench_torch.fresh_state(kind, device, 0.0, dtype=None if dtype == torch.float64 else dtype)
        if dtype == torch.float64:
            state.model.to(dtype)
        elif any(p.dtype != torch.float32 for p in state.model.parameters()):
            raise RuntimeError("a bfloat16 model holds parameters other than float32")
        batch = {k: v.to(torch.float64) if v.is_floating_point() and dtype == torch.float64 else v
                 for k, v in train_batch(torch, 2, device).items()}
        wrapper = ss.scatter_smem_cuda

        def recorded(idx, g, n):  # f's inputs and what the step received, as CPU copies
            out = wrapper(idx, g, n)
            record.append((idx.cpu(), g.cpu(), n, out.cpu()))
            return out

        if record is not None:
            ss.scatter_smem_cuda = recorded
        try:
            res = ts.train_step(state, batch, num_classes=20)
        finally:
            ss.scatter_smem_cuda = wrapper
        return float(res["loss"]), {k: p.grad.cpu().double() for k, p in state.model.named_parameters()}

    if kind not in F64_GRADS:
        F64_GRADS[kind] = step("cpu", torch.float64)[1]
    ref, (cpu_loss, cpu_g) = F64_GRADS[kind], step("cpu", torch.bfloat16)

    def median(g, want):
        errs = grad_errors(g, want)
        return errs[len(errs) // 2][0]

    cpu_all, cpu_med = all_l2(cpu_g, ref), median(cpu_g, ref)

    def gate(what, g) -> bool:
        card_all, card_med, direct = all_l2(g, ref), median(g, ref), median(g, cpu_g)
        ok = (card_all <= BF16_GRAD_VS_CPU * cpu_all and card_med <= BF16_GRAD_VS_CPU * cpu_med
              and direct <= cpu_all)
        print(f"train step {kind.upper()} bfloat16 gradients, {what}: vs a float64 CPU step, over all "
              f"parameters {card_all:.3e} (CPU bfloat16 {cpu_all:.3e}, ratio {card_all / cpu_all:.3f}, bound "
              f"{BF16_GRAD_VS_CPU}), median tensor {card_med:.3e} (CPU {cpu_med:.3e}, ratio "
              f"{card_med / cpu_med:.3f}); vs the CPU's bfloat16 step, median tensor {direct:.3e} (bound "
              f"{cpu_all:.3e}): {'pass' if ok else 'fail'}", flush=True)
        return ok

    def f_exact(what, record) -> bool:
        ok = all(torch.equal(out, ss.scatter_smem_plain(idx, g, n)) for idx, g, n, out in record)
        if config == "mxu":
            print(f"train step {kind.upper()} bfloat16 f, {what}: {len(record)} outputs "
                  f"{'equal' if ok else 'NOT equal'} to the plain version on CPU copies of their inputs",
                  flush=True)
        return ok and (config != "mxu" or len(record) > 0)

    kernels.reset_launch_counts()
    record = []
    gpu_loss, gpu_g = step("cuda", torch.bfloat16, record)
    bf16_launches = kernels.bf16_launch_counts()
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"train step {kind.upper()} bfloat16 ({config} config) card vs CPU (2 x {NPOINTS}): loss {gpu_loss} "
          f"vs {cpu_loss} (rel {loss_err:.2e}, bound {BF16_LOSS_RTOL}); bfloat16 launches {bf16_launches}",
          flush=True)
    check_bf16_launches(bf16_launches, True, True, f"{kind.upper()} bfloat16 card step", config)
    if not loss_err <= BF16_LOSS_RTOL:
        raise RuntimeError("bfloat16 train step: the card's loss disagrees with the CPU's")
    if not (gate("the card", gpu_g) and f_exact("the card", record)):
        raise RuntimeError("bfloat16 train step: the card's gradients are further from the float64 "
                           "and the CPU's bfloat16 gradients than the gates allow, or f's differ")
    module, name, short = (ss, "scatter_smem_cuda", "f") if config == "mxu" else (sc, "scatter_add_cuda", "h")
    for scale, what in ((0.5, f"{short} halved"), (0.0, f"{short} zeroed")):
        record = []
        with scaled(module, name, scale):
            broken = step("cuda", torch.bfloat16, record)[1]
        distances = gate(f"the card with {what} (must fail)", broken)
        if distances and f_exact(f"the card with {what} (must fail)", record):
            raise RuntimeError(f"bfloat16 train step: the gates pass the card's step with {what}")


def eval_run(torch, run: pathlib.Path, kind: str, config: str = "default") -> dict:
    """Phases 23 and 24: scripts/eval_torch.py on a run dir that
    train_torch.py --bf16 wrote (2 synthetic scenes, batch 32), under the
    configuration's switches: the model's forward kernels launched on
    bfloat16 rows, every metric finite and in [0, 1]."""
    import math

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    eval_torch = load_script("eval_torch")
    args = eval_torch.parse_args(["--folder", str(run), "--device", "cuda", "--synthetic", "--synthetic_scenes",
                                  "2", "--batch_size", str(BATCH)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    report = eval_torch.evaluate(args)
    torch.cuda.synchronize()
    launches, bf16_launches = kernels.launch_counts(), kernels.bf16_launch_counts()
    what = f"eval_torch.py {kind.upper()} bfloat16 run dir ({config} config)"
    print(f"{what}: launches {launches}, bfloat16 launches {bf16_launches}; point acc "
          f"{report.point_acc:.4f}, voxel mIoU {report.voxel_miou:.4f}", flush=True)
    check_launches(launches, kind, False, what, config)
    check_bf16_launches(bf16_launches, True, False, what, config)
    values = [report.point_acc, report.voxel_acc, report.voxel_cali_acc, report.point_miou, report.voxel_miou]
    if len(report.scenes) != 2 or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        raise RuntimeError(f"{what}: {len(report.scenes)} scenes, metrics {values}")
    return {"launches": launches, "bf16_launches": bf16_launches}


def same_files(a: pathlib.Path, b: pathlib.Path, what: str) -> None:
    """Raise unless two output dirs hold the same files, byte for byte."""
    names = sorted(p.name for p in a.iterdir())
    if not names or names != sorted(p.name for p in b.iterdir()):
        raise RuntimeError(f"{what}: {names} against {sorted(p.name for p in b.iterdir())}")
    for name in names:
        if (a / name).read_bytes() != (b / name).read_bytes():
            raise RuntimeError(f"{what}: {name} differs")


def steady_pair(first, second, batch, reps: int = 9) -> tuple[float, float]:
    """Median ms of first.predict(batch) and second.predict(batch), timed in
    turns after a warm-up of each."""
    first.predict(batch)
    second.predict(batch)
    times = ([], [])
    for _ in range(reps):
        for t, predictor in zip(times, (first, second)):
            t0 = time.perf_counter()
            predictor.predict(batch)
            t.append(time.perf_counter() - t0)
    return tuple(1e3 * sorted(t)[reps // 2] for t in times)


def serve_artifacts(torch, tmp: pathlib.Path) -> list:
    """Phase 25: the run dirs served through artifacts (see the module
    docstring); returns each artifact run's launches."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.engine.export import Predictor, ServingPredictor
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    infer_torch = load_script("infer_torch")
    batch = serving_columns(2)[:BATCH]
    runs = []

    def infer(*argv) -> tuple[dict, dict, dict]:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        stats = infer_torch.infer(infer_torch.parse_args([*argv, "--device", "cuda"]))
        torch.cuda.synchronize()
        return stats, kernels.launch_counts(), kernels.bf16_launch_counts()

    for kind, dtype in (("ssg", "float32"), ("msg", "float32"), ("ssg", "bfloat16")):
        t0 = time.perf_counter()
        name = f"{kind.upper()} {dtype} artifact"
        run = make_run(torch, tmp / f"run_{kind}_{dtype}", kind, compute_dtype=dtype)
        scenes = ["--synthetic", "--synthetic_scenes", "4", "--write_ply"]
        infer("--folder", str(run), *scenes, "--out", str(tmp / f"{kind}_{dtype}_run_dir"))
        path = tmp / f"{kind}_{dtype}.pt2"
        exported, launches, _ = infer("--folder", str(run), "--export", str(path), "--platforms", "cuda")
        if any(launches.values()):
            raise RuntimeError(f"exporting the {name} launched {launches}")
        out = tmp / f"{kind}_{dtype}_artifact"
        _, launches, bf16_launches = infer("--folder", str(run), "--from_artifact", str(path), *scenes,
                                           "--out", str(out))
        print(f"serve {name}: launches {launches}, bfloat16 launches {bf16_launches}", flush=True)
        check_launches(launches, kind, False, f"{name} serving")
        check_bf16_launches(bf16_launches, dtype == "bfloat16", False, f"{name} serving")
        same_files(out, tmp / f"{kind}_{dtype}_run_dir", f"{name} against its run dir")
        runs.append({"launches": launches, "bf16_launches": bf16_launches})
        runs_s = time.perf_counter() - t0
        eager = Predictor.from_run(run, batch_size=BATCH, device="cuda")
        eager_ms, artifact_ms = steady_pair(eager, ServingPredictor.from_artifact(path), batch)
        print(f"artifact {name}: exported in {exported['export_s']:.2f} s, {exported['nodes']} graph nodes, "
              f"{exported['mb']:.2f} MB; steady batch of {len(batch)} x {NPOINTS} in {artifact_ms:.2f} ms "
              f"against Predictor's {eager_ms:.2f} ms (median of 9, in turns); run dir, export and "
              f"artifact serving runs {runs_s:.1f} s", flush=True)

    # the SSG run dir's artifact traced on the CPU at 8 x 8192, served on the card
    run, path = tmp / "run_ssg_float32", tmp / "ssg_cpu.pt2"
    exported, _, _ = infer("--folder", str(run), "--export", str(path), "--platforms", "cpu", "cuda",
                           "--batch_size", "8")
    columns = serving_columns(1)[:20]  # ragged onto batches of 8
    kernels.reset_launch_counts()
    got = ServingPredictor.from_artifact(path, devices=["cuda"]).predict(columns)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    what = "SSG float32 artifact traced on the CPU"
    print(f"serve {what} on the card: launches {launches}; exported in {exported['export_s']:.2f} s, "
          f"{exported['nodes']} graph nodes, {exported['mb']:.2f} MB", flush=True)
    check_launches(launches, "ssg", False, f"{what} serving")
    runs.append({"launches": launches})
    want = Predictor.from_run(run, batch_size=8, device="cuda").predict(columns)
    if not np.array_equal(got, want):
        raise RuntimeError(f"{what}: labels differ from Predictor's at {int((got != want).sum())} points")
    return runs


def seeded_enet(torch):
    """ENetSemSeg (41 classes) in eval mode on the CPU: torch's default
    initialisation from seed 0, BatchNorm running statistics drawn from
    numpy's generator seeded 0."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.models.enet import ENetSemSeg

    torch.manual_seed(0)
    model = ENetSemSeg(41)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
    return model.eval()


def enet_frames(n: int, seed: int):
    """n random RGB frames of 256 x 328, normalised for ENet (float32 numpy)."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.models.enet import normalize_frame

    rgb = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 256, 328, 3))
    return normalize_frame(rgb).astype(np.float32)


def enet_card_vs_cpu(torch) -> None:
    """Phase 26: ENet's eval logits on ENET_BATCH frames, card against CPU;
    then scripts/bench_enet_torch.py's frames/s (B 64, float32 and
    bfloat16)."""
    model = seeded_enet(torch)
    x = torch.from_numpy(enet_frames(ENET_BATCH, 0))
    with torch.inference_mode():
        want = model(x)
        got = model.to("cuda")(x.to("cuda")).cpu()
    err = float((got - want).abs().max())
    print(f"ENet (41 classes) {tuple(x.shape)} card vs CPU: logits {tuple(got.shape)}, max_abs_err {err} "
          f"(max |logit| {float(want.abs().max())}; rtol {ENET_RTOL}, atol {ENET_ATOL})", flush=True)
    torch.testing.assert_close(got, want, rtol=ENET_RTOL, atol=ENET_ATOL)
    row = load_script("bench_enet_torch").run("cuda")
    print(json.dumps(row), flush=True)
    print(f"ENet frames/s float32: {row['value']:.1f} ({row['forward_ms']:.3f} ms a batch of 64)", flush=True)
    print(f"ENet frames/s bfloat16: {row['bf16_frames_per_sec']:.1f} ({row['forward_ms_bf16']:.3f} ms a batch "
          f"of 64)", flush=True)


def correspondence_and_fusion(torch):
    """Phase 26: the correspondence of one synthetic scene (MV_POINTS points,
    MV_FRAMES cameras looking into it, depths rendered from it) on the card
    against the CPU; the multiview CLI's loop body
    (scripts/multiview_torch.process_frames: ENet, correspondence and fusion
    on the card) against fuse_scene_features on the CPU over the card's
    features and correspondences, bit for bit; both timed. Returns (scene,
    its fused (N, 128) features)."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.data import multiview as mv
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene, make_synthetic_views

    cam = mv.CameraConfig()
    scene = make_synthetic_scene(0, n_points=MV_POINTS)
    poses, depths = make_synthetic_views(scene, MV_FRAMES, cam, seed=0)
    pts = torch.from_numpy(np.ascontiguousarray(scene[:, :3]))
    want_v, want_p = mv.compute_correspondence_batch(pts, depths, poses, cam)
    card = pts.to("cuda")
    got_v, got_p = (t.cpu() for t in mv.compute_correspondence_batch(card, depths, poses, cam))
    differ = (got_v != want_v) | (got_p != want_p)
    margins = mv.decision_margins(pts, depths, poses, cam)
    flips = int(differ.sum())
    worst = float(margins[differ].max()) if flips else 0.0
    corr_ms = cuda_ms(lambda: mv.compute_correspondence_batch(card, depths, poses, cam), torch)
    print(f"correspondence {MV_POINTS} points x {MV_FRAMES} frames card vs CPU: {flips} of {differ.numel()} "
          f"(frame, point) pairs differ (largest decision margin among them {worst}); valid share "
          f"{float(want_v.float().mean()):.4f}; {corr_ms:.3f} ms a batch of {MV_FRAMES} frames on the card",
          flush=True)
    if flips > MV_FLIP_SHARE * differ.numel() or worst > MV_FLIP_MARGIN:
        raise RuntimeError(f"the card's correspondence differs at {flips} pairs, margins up to {worst}")

    encoder = seeded_enet(torch).encoder.to("cuda")
    frames = enet_frames(MV_FRAMES, 1)
    batches = [(frames[i:i + ENET_BATCH], depths[i:i + ENET_BATCH], poses[i:i + ENET_BATCH])
               for i in range(0, MV_FRAMES, ENET_BATCH)]
    fused = load_script("multiview_torch").process_frames(scene[:, :3], batches, encoder, "cuda", cam)
    with torch.inference_mode():
        feats = torch.cat([encoder(torch.from_numpy(c).to("cuda")) for c, _, _ in batches])
        v, p = mv.compute_correspondence_batch(card, depths, poses, cam)
        fuse_ms = cuda_ms(lambda: mv.fuse_scene_features(feats, v, p), torch)
    want = mv.fuse_scene_features(feats.cpu(), got_v, got_p).numpy()
    covered = float((np.abs(fused).sum(1) > 0).mean())
    print(f"fusion on the card ({MV_FRAMES} frames of ENet features {tuple(feats.shape[1:])} onto {MV_POINTS} "
          f"points): {covered:.4f} of the points covered, {'equal' if np.array_equal(fused, want) else 'DIFFERENT'}"
          f" to fuse_scene_features on the CPU; {fuse_ms:.3f} ms a scene on the card", flush=True)
    if fused.shape != (MV_POINTS, 128) or not np.array_equal(fused, want) or covered == 0.0:
        raise RuntimeError("the card's fused features differ from the CPU's fusion of the same inputs")
    return scene, fused


def mv131_train_eval(torch, tmp: pathlib.Path, scene, fused) -> dict:
    """Phase 26: the SSG mv131 recipe (--use_normal --use_multiview, 131
    input channels) trained by the Solver for 3 steps of 32 x 8192 from
    MV_SCENES scenes written to tmp/<sid>.npy and read back with
    SceneStore.from_npy_dir, their features in memory (no HDF5 file, so no
    h5py): scene 0 carries the fused features of correspondence_and_fusion,
    the others label-correlated ones. Then the run dir's model_best
    evaluated on the val scenes by the whole-scene evaluator. Each run
    launches a, b, d, h (training) and i and no other kernel, SA1 taking the
    pregather in every forward. Returns the runs' launches."""
    import contextlib
    import io
    import math

    import numpy as np

    from pointnet2_scannet_tpu_torch.config import DataConfig, RunConfig, TrainConfig
    from pointnet2_scannet_tpu_torch.data import SceneStore, WholeSceneDataset, make_synthetic_scene
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.data.synthetic import attach_label_multiview
    from pointnet2_scannet_tpu_torch.engine.evaluator import WholeSceneEvaluator
    from pointnet2_scannet_tpu_torch.engine.export import load_run_model
    from pointnet2_scannet_tpu_torch.engine.solver import Solver
    from pointnet2_scannet_tpu_torch.models import model_from_config
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops import tuning

    ids = [f"mv{i:04d}_00" for i in range(MV_SCENES + MV_VAL_SCENES)]
    np.save(tmp / f"{ids[0]}.npy", scene)
    for i, sid in enumerate(ids[1:], 1):
        np.save(tmp / f"{sid}.npy", make_synthetic_scene(i))
    train = SceneStore.from_npy_dir(ids[:MV_SCENES], tmp)
    val = attach_label_multiview(SceneStore.from_npy_dir(ids[MV_SCENES:], tmp))
    train.multiview[ids[0]] = fused
    attach_label_multiview(train, skip={ids[0]})
    cfg = RunConfig(tag="chip_smoke_mv131",
                    data=DataConfig(npoints=NPOINTS, use_normal=True, use_multiview=True),
                    train=TrainConfig(batch_size=BATCH, epochs=3, verbose=1, seed=0))
    if cfg.data.input_channels != MV131:
        raise RuntimeError(f"the mv131 recipe has {cfg.data.input_channels} input channels")
    run_dir = tmp / "run_mv131"
    solver = Solver(model_from_config(cfg, generator=torch.Generator().manual_seed(0)),
                    ChunkedSceneDataset(train, cfg.data, phase="train", seed=0),
                    ChunkedSceneDataset(val, cfg.data, phase="val", seed=1), cfg, run_dir, device="cuda")

    def pregathers(forwards: int, what: str) -> None:
        got = {k: n for k, n in tuning.route_counts.items() if k[0] == "pregather"}
        if got != {("pregather", 1024): forwards}:
            raise RuntimeError(f"{what}: {forwards} forwards took the pregather at {got}, not at SA1 each")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tuning.reset_route_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            best = solver()
    finally:
        print(log.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    train_launches = kernels.launch_counts()
    what = f"mv131 SSG Solver ({MV_SCENES} scenes, 3 steps of {BATCH} x {NPOINTS}, {MV131} input channels)"
    print(f"{what}: launches {train_launches}, pregathers {dict(tuning.route_counts)}", flush=True)
    check_launches(train_launches, "ssg", True, what)
    pregathers(train_launches["furthest_point_sample"] // 4, what)
    losses = [v for _, v in solver.logger.scalars["train/loss"]] + [v for _, v in solver.logger.scalars["val/loss"]]
    if len(solver.logger.scalars["train/loss"]) != 3 or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"{what}: train/val losses {losses}")
    for f in ("model_best.pt", "model_last.pt", "config.json"):
        if not (run_dir / f).is_file():
            raise RuntimeError(f"{what} wrote no {f}")
    print(f"{what}: {took:.2f} s; losses {losses}; best val voxel mIoU {best['voxel_miou']:.4f}", flush=True)

    model, saved = load_run_model(run_dir)
    evaluator = WholeSceneEvaluator(model, device="cuda", batch_size=BATCH, num_classes=saved.model.num_classes)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tuning.reset_route_counts()
    report = evaluator.evaluate(WholeSceneDataset(val, saved.data, seed=0), verbose=False)
    torch.cuda.synchronize()
    eval_launches = kernels.launch_counts()
    what = f"mv131 SSG run dir evaluated ({MV_VAL_SCENES} scenes, batch {BATCH})"
    print(f"{what}: launches {eval_launches}; point acc {report.point_acc:.4f}, voxel mIoU "
          f"{report.voxel_miou:.4f}", flush=True)
    check_launches(eval_launches, "ssg", False, what)
    pregathers(eval_launches["furthest_point_sample"] // 4, what)
    values = [report.point_acc, report.voxel_acc, report.point_miou, report.voxel_miou]
    if len(report.scenes) != MV_VAL_SCENES or not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        raise RuntimeError(f"{what}: {len(report.scenes)} scenes, metrics {values}")
    return {"launches": {k: train_launches[k] + eval_launches[k] for k in train_launches}}


def pregather_gate(model):
    """gate(on): every set abstraction of model with its pregather gate as
    it stands (on) or forced off (the unfused composition at every level)."""
    from pointnet2_scannet_tpu_torch.models import SetAbstraction

    levels = [m for m in model.modules() if isinstance(m, SetAbstraction)]

    def gate(on: bool) -> None:
        for sa in levels:
            if on:
                vars(sa).pop("_pregather", None)
            else:
                sa._pregather = lambda features, widths: False

    return gate


def multiview(torch) -> dict:
    """Phase 26: ENet, the correspondence and the fusion on the card against
    the CPU; the mv131 recipe trained and evaluated through the kernels; its
    train step card vs CPU, determinism and steady time; SA1's pregather
    timed against the unfused composition. Returns the main-path launches."""
    enet_card_vs_cpu(torch)
    scene, fused = correspondence_and_fusion(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs = mv131_train_eval(torch, pathlib.Path(tmp), scene, fused)
    train_step_card_vs_cpu(torch, "ssg", input_channels=MV131)
    step = train_step_repeat_and_time(torch, "ssg", input_channels=MV131)
    print(f"mv131 SSG train step (32 x 8192, float32): {step['ms']:.2f} ms", flush=True)
    time_pregather(torch, "ssg", MV131)
    return runs


def dp_step_out(torch, state, out: dict) -> dict:
    """What phase 27 compares of a train step: the loss, the gradients the
    optimizer applied, the BatchNorm statistics, the parameters."""
    m = state.model
    return {"loss": float(out["loss"]),
            "grads": {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters()},
            "stats": {k: b.cpu().clone() for k, b in m.named_buffers() if b.is_floating_point()},
            "params": {k: p.detach().cpu().clone() for k, p in m.named_parameters()}}


def dp_accumulated_update(torch, state, micro_batches, ctx) -> dict:
    """One whole-scene update of state over a scene's micro-batches, each
    rank feeding its rows of each as WholeSceneSolver does; the gradients
    are read where the optimizer takes them."""
    from pointnet2_scannet_tpu_torch.data.pipeline import to_device
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    seen, step = {}, state.optimizer.step

    def spy(*args, **kwargs):
        seen.update({k: p.grad.detach().cpu().clone() for k, p in state.model.named_parameters()})
        return step(*args, **kwargs)

    state.optimizer.step = spy
    loss_sum = count = 0
    for mb in micro_batches:
        out = ts.grad_accum_step(state, to_device(ctx.place_from_global(mb), "cuda"), num_classes=20)
        loss_sum, count = loss_sum + out["loss_sum"], count + out["count"]
    totals = ts.sum_over_ranks({"loss_sum": loss_sum, "count": count}, ctx.group)
    ts.apply_accumulated(state, totals["count"], ctx.group)
    state.optimizer.step = step
    return {"loss": float(totals["loss_sum"]), "count": float(totals["count"]), "grads": seen,
            "stats": {k: b.cpu().clone() for k, b in state.model.named_buffers() if b.is_floating_point()}}


def dp_micro_batches() -> list:
    """Phase 27's scene: the first DP_WS_COLUMNS columns of synthetic scene 0
    at full width, in micro-batches of DP_WS_BATCH, the last padded."""
    from pointnet2_scannet_tpu_torch.engine.solver import _SceneBatchIterator

    scene = bench_torch.wholescene_dataset(1, NPOINTS).get_scene(0)
    return list(_SceneBatchIterator(None, DP_WS_BATCH).micro_batches(*(a[:DP_WS_COLUMNS] for a in scene)))


def f32_noise(torch, kind: str = "ssg") -> tuple[float, float]:
    """Phase 11's float32 noise of a model kind at 2 x NPOINTS: the CPU's
    float32 step's gradients' distance from its float64 step (relative L2
    over all parameters, and the median tensor's), from phase 11's cached
    CPU steps (taken here where phase 11 has not run)."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    out = CPU_STEPS.setdefault((kind, NPOINTS, 6), {})
    for dtype in (torch.float64, torch.float32):
        if ("cpu", dtype) not in out:
            state = bench_torch.fresh_state(kind, "cpu", 0.0)
            state.model.to(dtype)
            batch = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in train_batch(torch, 2, "cpu", NPOINTS).items()}
            ts.train_step(state, batch, num_classes=20)
            out[("cpu", dtype)] = (None, {k: p.grad for k, p in state.model.named_parameters()}, None)
    got, want = out[("cpu", torch.float32)][1], out[("cpu", torch.float64)][1]
    errs = grad_errors(got, want)
    return all_l2(got, want), errs[len(errs) // 2][0]


def dp_gates(torch, got: dict, want: dict, noise: tuple[float, float], what: str) -> None:
    """Phase 27 (b)'s (and 31 (a)'s) gates on one update against the single-process one:
    loss and BatchNorm statistics within phase 11's bounds; gradients within
    DP_GRAD_BOUND times phase 11's float32 noise of the single process's
    (relative L2 over all parameters, and the median tensor's, as phase 23
    holds bfloat16 gradients); the doubled gradient refused by that bound."""
    doubled = {k: 2 * g for k, g in got["grads"].items()}
    errs = grad_errors(got["grads"], want["grads"])
    med = len(errs) // 2
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    bn_err = max(float((got["stats"][k] - b).abs().max()) for k, b in want["stats"].items())

    def distances(g):
        return all_l2(g, want["grads"]), grad_errors(g, want["grads"])[med][0]

    def passes(g):
        return all(d <= DP_GRAD_BOUND * n for d, n in zip(distances(g), noise))

    print(f"{what}: loss rel {loss_err:.2e}; BatchNorm stats max abs err {bn_err:.2e}; gradients vs the "
          f"single-process step's, relative L2 over all parameters / median tensor / worst tensor: two ranks "
          f"{distances(got['grads'])[0]:.2e} / {errs[med][0]:.2e} / {errs[0][0]:.2e} ({errs[0][1]}), doubled "
          f"{distances(doubled)[0]:.2e} / {distances(doubled)[1]:.2e}; bound {DP_GRAD_BOUND} x phase 11's float32 "
          f"noise {noise[0]:.2e} / {noise[1]:.2e}", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"{what}: the two ranks' loss disagrees with the single process's")
    for k, b in want["stats"].items():
        torch.testing.assert_close(got["stats"][k], b, rtol=TRAIN_BN_TOL, atol=TRAIN_BN_TOL)
    if not passes(got["grads"]):
        raise RuntimeError(f"{what}: the two ranks' gradients are further from the single-process step's "
                           "than float32 noise allows")
    if passes(doubled):
        raise RuntimeError(f"{what}: the doubled gradient passed the gradient bound")


def dp_timed(torch, fn, warm: int = DP_WARM, timed: int = DP_TIMED) -> list:
    """Sorted host ms of `timed` synchronised calls of fn after `warm`."""
    out = []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def dp_rank(rank: int, port: int, tmp: str) -> None:
    """Phase 27 (b)-(d) on one of DP_RANKS gloo ranks sharing cuda:0; writes
    what it got to <tmp>/rank<rank>.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel.distributed import initialize_distributed, shutdown

    tmp = pathlib.Path(tmp)
    ctx = initialize_distributed(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda", backend="gloo")
    group, out = ctx.group, {}
    # (b) two train steps on this rank's rows, the steady step, one scene's update
    batch = train_batch(torch, DP_BATCH, "cuda")
    local = {k: v[rank * DP_BATCH // DP_RANKS : (rank + 1) * DP_BATCH // DP_RANKS] for k, v in batch.items()}
    state = bench_torch.fresh_state("ssg", "cuda", 0.0, bn_group=group)
    out["steps"] = [dp_step_out(torch, state, ts.train_step(state, local, num_classes=20, group=group))]
    out["after_step1"] = copy.deepcopy({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict()})
    out["steps"].append(dp_step_out(torch, state, ts.train_step(state, local, num_classes=20, group=group)))
    out["step_ms"] = dp_timed(torch, lambda: ts.train_step(state, local, num_classes=20, group=group))
    all_reduce = dist.all_reduce
    dist.all_reduce = lambda *args, **kwargs: None  # timing only: every all-reduce a no-op
    try:
        out["step_ms_no_all_reduce"] = dp_timed(torch, lambda: ts.train_step(state, local, num_classes=20,
                                                                               group=group))
    finally:
        dist.all_reduce = all_reduce
    ctx.barrier("steps timed")
    state = bench_torch.fresh_state("ssg", "cuda", 0.0, bn_group=group)
    out["wholescene"] = dp_accumulated_update(torch, state, dp_micro_batches(), ctx)
    del state, batch, local
    # (c) the Solver through train_torch, each rank with an output root of its own
    train_torch = load_script("train_torch")
    args = train_torch.parse_args([
        "--synthetic", "--synthetic_scenes", str(DP_SCENES), "--batch_size", str(DP_BATCH), "--epoch",
        str(DP_EPOCHS), "--npoints", str(NPOINTS), "--use_color", "--use_normal", "--verbose", "1",
        "--device", "cuda", "--tag", "chip_smoke_dp", "--output_root", str(tmp / f"train{rank}")])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_dir, _ = train_torch.train(args, ctx)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = kernels.launch_counts()
    check_launches(out["launches"], "ssg", True, f"two-rank Solver run, rank {rank}")
    out["run_dir"] = str(run_dir)
    # (d) eval_torch's and visualize_torch's entry points on both ranks
    eval_torch, visualize_torch = load_script("eval_torch"), load_script("visualize_torch")
    argv = ["--folder", str(tmp / "eval_run"), "--device", "cuda", "--synthetic", "--synthetic_scenes",
            str(DP_EVAL_SCENES), "--batch_size", str(BATCH)]
    kernels.reset_launch_counts()
    report = eval_torch.evaluate_rank(eval_torch.parse_args(argv), ctx)
    out["report"] = None if report is None else report.format_table()
    out["eval_scenes"] = None if report is None else [r.scene_id for r in report.scenes]
    out["written"] = [str(w[0]) for w in visualize_torch.visualize_rank(visualize_torch.parse_args(argv), ctx)]
    out["eval_launches"] = kernels.launch_counts()
    check_launches(out["eval_launches"], "ssg", False, f"two-rank eval and visualize, rank {rank}")
    torch.save(out, tmp / f"rank{rank}.pt")
    shutdown(ctx)


def data_parallel(torch, tmp: pathlib.Path) -> dict:
    """Phase 27; returns the launches of its main-path runs (the NCCL rank's
    step, both ranks' Solver runs and evaluations)."""
    import math
    import os

    import numpy as np
    import torch.distributed as dist

    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel import ProcessContext, initialize_distributed
    from pointnet2_scannet_tpu_torch.parallel.distributed import free_port, shutdown, spawn

    card = bench_torch.card_line()
    # (a) one NCCL rank (env://, as torchrun starts one) against the plain step
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1", "RANK": "0"}
    os.environ.update(env)
    try:
        ctx = initialize_distributed(None, auto=True, device="cuda")
    finally:
        for k in env:
            os.environ.pop(k)
    if dist.get_backend(ctx.group) != "nccl":
        raise RuntimeError(f"the one-rank group runs {dist.get_backend(ctx.group)}, not NCCL")
    batch = train_batch(torch, DP_BATCH, "cuda")
    plain = bench_torch.fresh_state("ssg", "cuda", 0.5)
    dp = bench_torch.fresh_state("ssg", "cuda", 0.5, bn_group=ctx.group)
    want = dp_step_out(torch, plain, ts.train_step(plain, batch, num_classes=20))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = dp_step_out(torch, dp, ts.train_step(dp, batch, num_classes=20, group=ctx.group))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launches(launches, "ssg", True, "one-rank NCCL data-parallel step")
    differ = [f"{part}.{k}" for part in ("grads", "stats", "params") for k, v in want[part].items()
              if not torch.equal(got[part][k], v)]
    if got["loss"] != want["loss"] or differ:
        raise RuntimeError(f"the one-rank NCCL step differs from the plain step: loss {got['loss']} against "
                           f"{want['loss']}, tensors {differ[:5]}")
    times = {"nccl": [], "plain": []}
    for name, state, group in (("plain", plain, None), ("nccl", dp, ctx.group), ("nccl", dp, ctx.group),
                               ("plain", plain, None)):
        times[name] += dp_timed(torch, lambda: ts.train_step(state, batch, num_classes=20, group=group))
    print(f"data parallel (a), one NCCL rank, SSG {DP_BATCH} x {NPOINTS} x 9 (Dropout 0.5): the loss, "
          f"{len(want['grads'])} gradients, {len(want['stats'])} BatchNorm statistics and the parameters equal "
          f"bit for bit to the plain step's; launches {launches}; step ms median (min, max) of "
          f"{2 * DP_TIMED} in turns: NCCL {np.median(times['nccl']):.2f} ({min(times['nccl']):.2f}, "
          f"{max(times['nccl']):.2f}), plain {np.median(times['plain']):.2f} ({min(times['plain']):.2f}, "
          f"{max(times['plain']):.2f}); {card}", flush=True)
    shutdown(ctx)
    del plain, dp, state

    # (b)'s single-process references on the card, and phase 11's float32 noise
    state = bench_torch.fresh_state("ssg", "cuda", 0.0)
    refs = [dp_step_out(torch, state, ts.train_step(state, batch, num_classes=20))]
    mbs = dp_micro_batches()
    ws = dp_accumulated_update(torch, bench_torch.fresh_state("ssg", "cuda", 0.0), mbs,
                               ProcessContext.single("cuda"))
    noise = f32_noise(torch)
    del batch, state
    make_run(torch, tmp / "eval_run", "ssg")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spawn(dp_rank, DP_RANKS, (free_port(), str(tmp)), timeout=600)
    spawned_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False, map_location="cpu") for r in range(DP_RANKS)]
    # the second step starts, on one process as on the ranks, from the ranks'
    # state after the first (Adam's first update is lr * sign(g): float32
    # noise flips it where g is near 0, so two separate runs part there)
    state = bench_torch.fresh_state("ssg", "cuda", 0.0)
    state.model.load_state_dict(ranks[0]["after_step1"]["model"])
    state.optimizer.load_state_dict(ranks[0]["after_step1"]["optimizer"])
    state.step = 1
    refs.append(dp_step_out(torch, state, ts.train_step(state, train_batch(torch, DP_BATCH, "cuda"),
                                                        num_classes=20)))
    del state

    # (b)
    masks = [int(mb["row_mask"].sum()) for mb in mbs]
    for r, out in enumerate(ranks):
        for i in range(2):
            dp_gates(torch, out["steps"][i], refs[i], noise,
                     f"data parallel (b), rank {r} of {DP_RANKS} gloo ranks on cuda:0, train step {i + 1}")
        dp_gates(torch, out["wholescene"], ws, noise,
                 f"data parallel (b), rank {r}, one whole-scene update ({len(mbs)} micro-batches of "
                 f"{DP_WS_BATCH}, {masks} real rows)")
        if out["wholescene"]["count"] != ws["count"]:
            raise RuntimeError("data parallel (b): the ranks counted other points than the single process")
        ms, bare = np.median(out["step_ms"]), np.median(out["step_ms_no_all_reduce"])
        print(f"data parallel (b), rank {r}: step of {DP_BATCH // DP_RANKS} x {NPOINTS} a rank, ms median (min, "
              f"max) of {DP_TIMED}: {ms:.2f} ({out['step_ms'][0]:.2f}, {out['step_ms'][-1]:.2f}); every "
              f"all-reduce a no-op: {bare:.2f}; the all-reduces' share {(ms - bare) / ms:.3f}; {card}", flush=True)
    for k, v in ranks[0]["steps"][1]["params"].items():
        if not torch.equal(v, ranks[1]["steps"][1]["params"][k]):
            raise RuntimeError(f"data parallel (b): the ranks' parameters differ after two steps ({k})")
    # (c)
    run_dir = pathlib.Path(ranks[0]["run_dir"])
    if run_dir.parent != tmp / "train0" or (tmp / "train1").exists():
        raise RuntimeError(f"data parallel (c): rank 0 ran in {run_dir}, or rank 1 wrote a run dir")
    scalars = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    losses = [v for _, v in scalars["train/loss"]] + [v for _, v in scalars["val/loss"]]
    if len(scalars["train/loss"]) != DP_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"data parallel (c): losses {losses}, not {DP_EPOCHS} epochs of finite values")
    print(f"data parallel (c): train_torch.train on {DP_RANKS} ranks, {DP_SCENES} scenes, batch {DP_BATCH}, "
          f"{DP_EPOCHS} epochs in {[round(out['train_s'], 2) for out in ranks]} s; losses {losses}; launches "
          f"{[out['launches'] for out in ranks]}; rank 0 alone wrote a run dir", flush=True)
    # (d)
    eval_torch = load_script("eval_torch")
    single = eval_torch.evaluate(eval_torch.parse_args([
        "--folder", str(tmp / "eval_run"), "--device", "cuda", "--synthetic", "--synthetic_scenes",
        str(DP_EVAL_SCENES), "--batch_size", str(BATCH)]))
    if ranks[0]["report"] != single.format_table() or ranks[1]["report"] is not None:
        raise RuntimeError("data parallel (d): the merged report differs from the single-process report")
    if ranks[0]["eval_scenes"] != [r.scene_id for r in single.scenes]:
        raise RuntimeError(f"data parallel (d): merged scenes {ranks[0]['eval_scenes']}")
    plys = sorted(map(str, (tmp / "eval_run" / "preds").glob("*.ply")))
    if len(plys) != DP_EVAL_SCENES or plys != sorted(w for out in ranks for w in out["written"]):
        raise RuntimeError(f"data parallel (d): PLY files {plys}")
    print(f"data parallel (d): {DP_EVAL_SCENES} scenes on {DP_RANKS} ranks ({[len(o['written']) for o in ranks]} "
          f"each): the merged report equals the single-process report; {len(plys)} PLY files; eval launches "
          f"{[out['eval_launches'] for out in ranks]}; the spawned ranks took {spawned_s:.1f} s", flush=True)
    total = dict(launches)
    for out in ranks:
        for part in ("launches", "eval_launches"):
            for k, n in out[part].items():
                total[k] += n
    return {"launches": total}


def fused_batches(k: int, batch: int, seed: int) -> list:
    """k host batches of full-width random columns (xyz in a 1.5 m cube,
    6 feature channels, 20 classes, per-point weights)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"points": np.concatenate([rng.uniform(0, 1.5, (batch, NPOINTS, 3)),
                                       rng.uniform(-1, 1, (batch, NPOINTS, 6))], -1).astype(np.float32),
             "labels": rng.integers(0, 20, (batch, NPOINTS)).astype(np.int32),
             "weights": rng.uniform(0.5, 2.0, (batch, NPOINTS)).astype(np.float32),
             "row_mask": np.ones(batch, np.float32)} for _ in range(k)]


def resident_store(torch) -> dict:
    """A device store of 2 x FUSED_K x BATCH full-width random columns."""
    import numpy as np

    cols = fused_batches(2 * FUSED_K, BATCH, 0)
    return {"points": torch.from_numpy(np.concatenate([c["points"].reshape(-1, 9) for c in cols])).cuda(),
            "labels": torch.from_numpy(np.concatenate([c["labels"].reshape(-1) for c in cols])).cuda(),
            "wtable": torch.linspace(0.5, 2.0, 20, device="cuda")}


def resident_batches(store: dict, k: int, seed: int) -> list:
    """k resident batches naming BATCH x NPOINTS rows of store each, with
    augmentation parameters (rotations about z, translations, scales)."""
    import numpy as np

    rows = store["points"].shape[0]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        angle = rng.uniform(-0.1, 0.1, BATCH)
        rot = np.zeros((BATCH, 3, 3), np.float32)
        rot[:, 0, 0] = rot[:, 1, 1] = np.cos(angle)
        rot[:, 0, 1], rot[:, 1, 0], rot[:, 2, 2] = -np.sin(angle), np.sin(angle), 1.0
        out.append({"idx": rng.integers(0, rows, (BATCH, NPOINTS)).astype(np.int32),
                    "row_mask": np.ones(BATCH, np.float32), "rot": rot,
                    "trans": rng.uniform(-0.5, 0.5, (BATCH, 3)).astype(np.float32),
                    "scale": rng.uniform(0.95, 1.05, BATCH).astype(np.float32)})
    return out


def whole_state(state) -> dict:
    """Everything a train step changes: parameters and BatchNorm statistics,
    Adam's moments and step counts, the Dropout generator, the step count."""
    opt = state.optimizer
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "adam": {f"{i}.{k}": v.clone() for i, p in enumerate(state.model.parameters())
                     for k, v in opt.state[p].items()},
            "generator": state.generator.get_state(), "step": state.step}


def state_differs(torch, got: dict, want: dict) -> list:
    differ = [f"model.{k}" for k, v in want["model"].items() if not torch.equal(got["model"][k], v)]
    differ += [f"adam.{k}" for k, v in want["adam"].items() if not torch.equal(got["adam"][k], v)]
    if not torch.equal(got["generator"], want["generator"]) or got["step"] != want["step"]:
        differ.append("generator or step")
    return differ


def csrc_kernels() -> set:
    """The names of the __global__ functions in csrc/."""
    import re

    csrc = ROOT / "pointnet2_scannet_tpu_torch" / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    return {m for f in sorted(csrc.glob("*.cu*")) for m in pattern.findall(f.read_text())}


def replay_kernels(torch, fn) -> dict:
    """The hand-written kernels that one call of fn launches on the card, by
    TPU kernel letter, from a torch.profiler trace ("other:<name>" for a
    csrc/ kernel outside TRACE_LETTERS; PyTorch's own kernels are left out)."""
    import collections
    import re

    from torch.profiler import ProfilerActivity, profile

    ours = csrc_kernels()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.match(r"void \(anonymous namespace\)::(.*)", e.name)
        if m is None or re.match(r"\w+", m.group(1)).group(0) not in ours:
            continue
        letters = [c for c, pattern in TRACE_LETTERS if re.match(pattern, m.group(1))]
        out[letters[0] if letters else "other:" + m.group(1).split("(")[0]] += 1
    return dict(out)


def fused_vs_eager(torch, kind: str, *, dtype=None, resident: bool = False, group=None) -> dict:
    """Phase 28 (a), (b), (d): from one seeded state, FUSED_K eager steps and
    one CUDA graph launch of the fused step over the same BATCH x NPOINTS
    batches (Dropout 0.5) must agree bit for bit: losses, confusions, every
    parameter and BatchNorm statistic, Adam's moments and step counts, the
    Dropout generator; the capture must count FUSED_K times an eager step's
    launches; a second group's launch, traced by torch.profiler, must equal
    FUSED_K more eager steps and launch the path's hand-written kernels and
    no other, none more often than the capture counted. Returns the states, the
    fused step and this run's launches (the warm-up's and the capture's)."""
    from pointnet2_scannet_tpu_torch.data.pipeline import HostGroup
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel.step import make_fused_train_step, make_resident_fused_train_step

    name = (f"{kind.upper()} {'bfloat16' if dtype is not None else 'float32'}{', device store' * resident}"
            f"{', one NCCL rank' * (group is not None)}")
    eager, graph = (bench_torch.fresh_state(kind, "cuda", 0.5, dtype=dtype, bn_group=group) for _ in range(2))
    fused = (make_resident_fused_train_step if resident else make_fused_train_step)(
        graph.model, group, num_classes=20, log=print)
    if fused.mode != "graph":
        raise RuntimeError(f"fused steps {name}: mode {fused.mode}, not one CUDA graph")
    store = None
    per_step = run_launches = None
    for group_index in range(2):
        if resident:
            store = store or resident_store(torch)
            batches = resident_batches(store, FUSED_K, group_index)
        else:
            batches = fused_batches(FUSED_K, BATCH, group_index)
        want = []
        for i, b in enumerate(batches):
            if i == 1 and per_step is None:
                per_step = kernels.launch_counts()
            if i == 0:
                kernels.reset_launch_counts()
            b = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
            want.append(ts.resident_train_step(eager, store, b, num_classes=20, group=group) if resident
                        else ts.train_step(eager, b, num_classes=20, group=group))
        host = HostGroup(batches, pin=True)
        call = (lambda: fused(graph, store, host)) if resident else (lambda: fused(graph, host))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        if group_index == 0:
            got = call()
            torch.cuda.synchronize()
            run_launches = kernels.launch_counts()
        else:
            box = {}
            traced = replay_kernels(torch, lambda: box.update(got=call()))
            got = box["got"]
        differ = state_differs(torch, whole_state(graph), whole_state(eager))
        if not (torch.equal(got["loss"], torch.stack([w["loss"] for w in want]))
                and torch.equal(got["confusion"], torch.stack([w["confusion"] for w in want]))) or differ:
            raise RuntimeError(f"fused steps {name}, group {group_index + 1}: the graph launch differs from "
                               f"{FUSED_K} eager steps (losses {got['loss'].tolist()} against "
                               f"{[float(w['loss']) for w in want]}; tensors {differ[:6]})")
    capture = fused.captures[0]
    if capture["launches"] != {k: FUSED_K * n for k, n in per_step.items()}:
        raise RuntimeError(f"fused steps {name}: the capture counted {capture['launches']}, not {FUSED_K} x "
                           f"an eager step's {per_step}")
    # the path's kernels and no other; none more often than the capture
    # recorded (fewer: events the profiler dropped, reported)
    want_letters = {c: capture["launches"][k] for c, k in LETTER_KERNEL.items() if capture["launches"][k]}
    if set(traced) != set(want_letters) or any(traced[c] > n for c, n in want_letters.items()):
        raise RuntimeError(f"fused steps {name}: one replay launched the hand-written kernels {traced}, not "
                           f"the capture's {want_letters}")
    dropped = {c: n - traced[c] for c, n in want_letters.items() if traced[c] < n}
    print(f"fused steps {name} (K {FUSED_K}, {BATCH} x {NPOINTS}, Dropout 0.5): two CUDA graph launches "
          f"each equal bit for bit to {FUSED_K} eager steps (losses, confusions, {len(want_letters)} kernels' "
          f"path, {sum(1 for _ in graph.model.parameters())} parameters, BatchNorm statistics, Adam state, "
          f"generator); capture {capture['seconds']:.2f} s (warm-up included), pool "
          f"{capture['pool_bytes'] / 2**20:.1f} MiB; capture counts {FUSED_K} x an eager step's {per_step}; one "
          f"replay's trace {traced} (events the profiler dropped: {dropped or 'none'})", flush=True)
    return {"eager": eager, "graph": graph, "fused": fused, "store": store,
            "launches": run_launches}


def fused_timing(torch, run: dict, group=None) -> dict:
    """Phase 28 (c), (d): ms a step, eager (one train_step on a device
    batch) against the graph (one launch of FUSED_K steps fed from a pinned
    host group, as the Solver feeds it, / FUSED_K): FUSED_WINDOWS windows of
    FUSED_WINDOW_STEPS steps each (FUSED_NCCL_WINDOW_STEPS with a group),
    CUDA events."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.data.pipeline import HostGroup
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    batches = fused_batches(FUSED_K, BATCH, 7)
    host = HostGroup(batches, pin=True)
    device = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]
    steps = FUSED_WINDOW_STEPS if group is None else FUSED_NCCL_WINDOW_STEPS
    i = iter(range(10**9))
    eager = bench_torch.timed_windows(
        lambda: ts.train_step(run["eager"], device[next(i) % FUSED_K], num_classes=20, group=group), "cuda",
        steps, FUSED_WINDOWS, 2)
    graph = [ms / FUSED_K for ms in bench_torch.timed_windows(
        lambda: run["fused"](run["graph"], host), "cuda", steps // FUSED_K, FUSED_WINDOWS, 1)]
    out = {"eager": eager, "graph": graph}
    print("fused steps timing" + (" (one NCCL rank)" if group is not None else "") + ", ms a step of "
          f"{BATCH} x {NPOINTS}, median (min, max) of {FUSED_WINDOWS} windows of {steps} steps: "
          + "; ".join(f"{k} {np.median(v):.3f} ({v[0]:.3f}, {v[-1]:.3f})" for k, v in out.items())
          + f"; {bench_torch.card_line()}", flush=True)
    return out


def fused_dp_rank(rank: int, port: int, tmp: str) -> None:
    """Phase 28 (e) on one of DP_RANKS gloo ranks sharing cuda:0: the
    chunked Solver over this rank's shard of FUSED_SCENES scenes (global
    batch FUSED_BATCH, augmentation off, one epoch: one group a rank) on the
    host path, then from the rank's device store with --fused_steps
    FUSED_K; writes the per-step losses, the output and the launches to
    <tmp>/fused_rank<rank>.pt."""
    import contextlib
    import io

    import torch

    sys.path.insert(0, str(ROOT))
    from pointnet2_scannet_tpu_torch.config import DataConfig, RunConfig, TrainConfig
    from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.solver import Solver
    from pointnet2_scannet_tpu_torch.models import get_model
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel.distributed import initialize_distributed, shutdown

    tmp = pathlib.Path(tmp)
    ctx = initialize_distributed(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda", backend="gloo")
    shard = bench_torch.solver_store(FUSED_SCENES, FUSED_DP_POINTS).shard(rank, DP_RANKS)
    got, step = {}, ts.train_step
    for path in ("host", "resident"):
        losses = []

        def recorded(state, batch, **kwargs):  # the fused steps and resident_train_step call it too
            out = step(state, batch, **kwargs)
            losses.append(out["loss"])
            return out

        cfg = RunConfig(tag="chip_smoke", data=DataConfig(npoints=NPOINTS, use_color=True, use_normal=True,
                                                          augment=False),
                        train=TrainConfig(batch_size=FUSED_BATCH, epochs=1, verbose=0, seed=0,
                                          device_store=path == "resident",
                                          fused_steps=FUSED_K if path == "resident" else 1))
        ds = ChunkedSceneDataset(shard, cfg.data, phase="train", seed=0)
        model = get_model(20, is_msg=False, input_channels=6, bn_group=ctx.group,
                          generator=torch.Generator().manual_seed(0))
        log = io.StringIO()
        ts.train_step = recorded
        try:
            with contextlib.redirect_stdout(log):
                solver = Solver(model, ds, None, cfg, tmp / f"fused_{path}", device=ctx.device, process_ctx=ctx)
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                solver()
                torch.cuda.synchronize()
        finally:
            ts.train_step = step
        got[path] = {"losses": torch.stack(losses).cpu(), "log": log.getvalue(), "launches": kernels.launch_counts(),
                     "device_store": solver.device_store, "steps": solver.state.step,
                     "mode": solver._fused_step.describe(FUSED_K) if solver._fused_step is not None else None}
        check_launches(got[path]["launches"], "ssg", True, f"two-rank {path} Solver, rank {rank}")
        del solver, model
    torch.save(got, tmp / f"fused_rank{rank}.pt")
    shutdown(ctx)


def fused_cli(torch, tmp: pathlib.Path) -> dict:
    """Phase 28 (f): phase 10's SSG run through train_torch.py at batch
    FUSED_BATCH (an epoch of FUSED_SCENES scenes is one group of FUSED_K),
    --fused_steps FUSED_K, 1 epoch, then a resume for a second: the mode line
    and the capture line in both, finite losses, the kernels of the path."""
    import contextlib
    import io
    import math
    import re

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    train_torch = load_script("train_torch")
    argv = ["--synthetic", "--synthetic_scenes", str(FUSED_SCENES), "--batch_size", str(FUSED_BATCH),
            "--npoints", str(NPOINTS), "--use_color", "--use_normal", "--verbose", str(FUSED_K), "--device",
            "cuda", "--tag", "chip_smoke_fused", "--output_root", str(tmp / "fused_cli")]
    line = (f"{FUSED_SCENES // FUSED_BATCH} steps per epoch, fused_steps {FUSED_K}: one CUDA graph per "
            f"{FUSED_K} steps")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logs, run_dir = [], None
    for extra in (["--epoch", "1", "--fused_steps", str(FUSED_K)], ["--epoch", "2", "--resume", "RUN"]):
        log = io.StringIO()
        extra = [str(run_dir) if a == "RUN" else a for a in extra]
        with contextlib.redirect_stdout(log):
            run_dir, _ = train_torch.train(train_torch.parse_args(argv + extra))
        logs.append(log.getvalue())
        print(log.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launches(launches, "ssg", True, "--fused_steps training and its resume")
    losses = [float(m) for log in logs for m in re.findall(r"done: train loss (\S+)", log)]
    for what, log in zip(("run", "resume"), logs):
        if line not in log or f"captured {FUSED_K} train steps as one CUDA graph" not in log:
            raise RuntimeError(f"train_torch.py --fused_steps {FUSED_K} ({what}) printed no '{line}' or no capture")
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"--fused_steps training: train losses {losses}, not 2 epochs of finite values")
    print(f"fused steps (f): train_torch.py --fused_steps {FUSED_K}, then --resume: '{line}' both times; "
          f"train losses {losses}; launches {launches}", flush=True)
    return {"launches": launches}


def fused_steps(torch, tmp: pathlib.Path) -> dict:
    """Phase 28; returns the launches of its main-path runs."""
    import os

    import numpy as np
    import torch.distributed as dist

    from pointnet2_scannet_tpu_torch.parallel import initialize_distributed
    from pointnet2_scannet_tpu_torch.parallel.distributed import free_port, shutdown, spawn

    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    def part(what: str) -> None:
        print(f"phase 28 {what} done after {time.perf_counter() - t0:.1f} s", flush=True)

    # (a), (c)
    run = fused_vs_eager(torch, "ssg")
    add(run["launches"])
    part("(a)")
    fused_timing(torch, run)
    del run
    part("(c)")
    # (b)
    for kind, dtype, resident in (("msg", None, False), ("ssg", torch.bfloat16, False), ("ssg", None, True)):
        add(fused_vs_eager(torch, kind, dtype=dtype, resident=resident)["launches"])
        part(f"(b) {kind} {dtype} {'resident' * resident}")
    torch.cuda.empty_cache()
    # (d) one NCCL rank (env://), its all-reduces captured in the graph
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1", "RANK": "0"}
    os.environ.update(env)
    try:
        ctx = initialize_distributed(None, auto=True, device="cuda")
    finally:
        for k in env:
            os.environ.pop(k)
    if dist.get_backend(ctx.group) != "nccl":
        raise RuntimeError(f"the one-rank group runs {dist.get_backend(ctx.group)}, not NCCL")
    run = fused_vs_eager(torch, "ssg", group=ctx.group)
    add(run["launches"])
    part("(d)'s check")
    fused_timing(torch, run, ctx.group)
    del run
    shutdown(ctx)
    part("(d)")
    torch.cuda.empty_cache()
    # (e) two gloo ranks sharing the card, each with its own device store
    spawn(fused_dp_rank, DP_RANKS, (free_port(), str(tmp)), timeout=300)
    ranks = [torch.load(tmp / f"fused_rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    mode = f"fused_steps {FUSED_K}: {FUSED_K} eager steps per group (gloo)"
    for r, got in enumerate(ranks):
        host, res = got["host"], got["resident"]
        if not res["device_store"] or "WARNING" in res["log"] or res["mode"] != mode:
            raise RuntimeError(f"fused steps (e), rank {r}: device_store {res['device_store']}, mode {res['mode']}, "
                               f"log {res['log'][-300:]!r}")
        if not torch.equal(res["losses"], host["losses"]) or res["steps"] != FUSED_K or host["steps"] != FUSED_K:
            raise RuntimeError(f"fused steps (e), rank {r}: losses {res['losses'].tolist()} against the host "
                               f"path's {host['losses'].tolist()}")
        add(res["launches"])
        add(host["launches"])
    if not torch.equal(ranks[0]["resident"]["losses"], ranks[1]["resident"]["losses"]):
        raise RuntimeError("fused steps (e): the ranks' global losses differ")
    print(f"fused steps (e): {DP_RANKS} gloo ranks on cuda:0, each from its own device store ({FUSED_SCENES} "
          f"scenes of {FUSED_DP_POINTS} points, global batch {FUSED_BATCH}): no WARNING, '{mode}', {ranks[0]['resident']['steps']} steps with "
          f"losses equal bit for bit to the data-parallel host path's {ranks[0]['host']['losses'].tolist()}; "
          f"launches {[got['resident']['launches'] for got in ranks]}", flush=True)
    part("(e)")
    # (f)
    add(fused_cli(torch, tmp)["launches"])
    print(f"phase 28 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": total}


def shape_spec(kind: str, msg: bool):
    from pointnet2_scannet_tpu_torch import models

    return {("cls", False): models.cls_ssg_spec, ("cls", True): models.cls_msg_spec,
            ("partseg", False): models.partseg_ssg_spec, ("partseg", True): models.partseg_msg_spec}[kind, msg]()


def shape_counts(kind: str, msg: bool) -> dict:
    """A forward's launches of a, b, c and i in a shape model, from its spec:
    FPS a level with centroids, one ball query a radius (a two-radius level
    one two-radius query), 3-NN an FP level with known points."""
    spec = shape_spec(kind, msg)
    levels = [radii for npoint, radii, _, _ in spec.sa_levels if npoint is not None]
    return {"furthest_point_sample": len(levels),
            "ball_query": sum(len(r) for r in levels if len(r) != 2),
            "ball_query_multi": sum(len(r) == 2 for r in levels),
            "three_nn": len(levels) if kind == "partseg" else 0}


def check_shape_launches(launches: dict, kind: str, msg: bool, forwards: int, training: bool,
                         what: str) -> None:
    """Phase 29: exactly the path's launches of a, b, c and i for `forwards`
    forwards, d, h in training, and none of the kernels a switch, a shape or a
    bench script selects."""
    want = {k: n * forwards for k, n in shape_counts(kind, msg).items()}
    wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
    stray = sorted(k for k in OFF_BY_DEFAULT if launches[k])
    if wrong or stray or not launches["gather"] or (launches["scatter_add"] > 0) != training:
        raise RuntimeError(f"the {what} run launched {launches}; {forwards} forwards want {want}, d, "
                           f"{'h' if training else 'no h'} and none of {sorted(OFF_BY_DEFAULT)}")


def shape_batch(kind: str, b: int, seed: int, augment: bool = True) -> dict:
    """A numpy batch of the family's recipe (data/shapes.py)."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.data import shapes

    draw = shapes.sample_cls_batch if kind == "cls" else shapes.sample_partseg_batch
    return draw(np.random.default_rng(seed), b, SHAPE_NPOINTS, SHAPE_COUNT, augment=augment)


def check_shape_kernels(torch, tallies) -> None:
    """Phase 29: a, b, c and i on the families' level clouds (a batch of the
    recipe's clouds, each level from the plain FPS of the one above), bit for
    bit against their plain versions, timed beside their bounds; d at the SSG
    forwards' gathers (centroids, SA1's and SA2's groupings, partseg's FP2
    and FP1 interpolations) and h at the train steps' backwards of those
    (SA1 groups the input: no gradient), as phases 3 and 4 check them."""
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda import three_nn_kernel as nn3
    from pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter import scan_points

    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind in ("cls", "partseg"):
        b = SHAPE_BATCH[kind]
        x = torch.from_numpy(shape_batch(kind, b, 1)["points"][..., :3]).to("cuda").contiguous()
        xyz = [x]
        for npoint in (512, 128):
            n = xyz[-1].shape[1]
            x = xyz[-1]
            check(torch, tallies[fps.NAME], kind,
                  f"fps {kind} ({b},{n})->{npoint} plan {tuple(fps.plan(n, x.dtype))}",
                  lambda: fps.furthest_point_sample_cuda(x, npoint),
                  lambda: fps.furthest_point_sample_plain(x, npoint),
                  4 * b * (3 * n + npoint), 10 * b * (npoint - 1) * n, steps=npoint - 1)
            idx = fps.furthest_point_sample_plain(x, npoint)
            gather_check(torch, tallies[ga.NAME], kind, f"gather {kind} centroids ({b},{n},3)x{npoint}", x, idx)
            xyz.append(ga.gather_plain(x, idx).contiguous())
        # the SSG forward's groupings (SA1: xyz alone; SA2: xyz and SA1's 128
        # features) and, for partseg, FP2's and FP1's interpolations
        backward = []
        for lvl, (_, (r,), (k,), mlps) in enumerate(shape_spec(kind, False).sa_levels[:2]):
            nidx = bq.ball_query_plain(r, k, xyz[lvl], xyz[lvl + 1]).reshape(b, -1)
            src = xyz[lvl] if lvl == 0 else torch.cat(
                [xyz[lvl], torch.randn((b, xyz[lvl].shape[1], 128), generator=gen, device="cuda")], -1)
            gather_check(torch, tallies[ga.NAME], kind,
                         f"gather {kind} SA{lvl + 1} grouping ({b},{src.shape[1]},{src.shape[2]})x{nidx.shape[1]}",
                         src.contiguous(), nidx)
            if lvl:
                backward.append((f"SA{lvl + 1} grouping", nidx, src.shape[1], src.shape[2]))
        if kind == "partseg":
            for lvl, c in ((1, 256), (0, 128)):  # FP2 interpolates SA2's 256 features, FP1 FP2's 128
                nidx = nn3.three_nn_plain(xyz[lvl], xyz[lvl + 1])[1].reshape(b, -1)
                known = torch.randn((b, xyz[lvl + 1].shape[1], c), generator=gen, device="cuda")
                gather_check(torch, tallies[ga.NAME], kind,
                             f"gather {kind} FP{lvl + 1} interpolation ({b},{known.shape[1]},{c})x{nidx.shape[1]}",
                             known, nidx)
                backward.append((f"FP{lvl + 1} interpolation", nidx, known.shape[1], c))
        check_scatter(torch, tallies["scatter_add"], kind, backward)
        seen = set()
        for spec in (shape_spec(kind, False), shape_spec(kind, True)):
            for lvl, (_, radii, ks, _) in enumerate(spec.sa_levels[:2]):
                x, q = xyz[lvl], xyz[lvl + 1]
                n, m = x.shape[1], q.shape[1]
                if len(radii) == 2:
                    scans = int(torch.maximum(scan_points(torch, x, q, radii[0], ks[0]),
                                              scan_points(torch, x, q, radii[1], ks[1])).sum())
                    check(torch, tallies[bqm.NAME], kind, f"ball_query_multi {kind} r={radii} N={n} M={m} ns={ks}",
                          lambda: bqm.ball_query_multi_cuda(radii, ks, x, q),
                          lambda: bqm.ball_query_multi_plain(radii, ks, x, q),
                          4 * b * (3 * n + 3 * m + m * sum(ks)), 10 * scans)
                    continue
                for r, k in zip(radii, ks):
                    if (lvl, r, k) in seen:
                        continue
                    seen.add((lvl, r, k))
                    scans = int(scan_points(torch, x, q, r, k).sum())
                    check(torch, tallies[bq.NAME], kind, f"ball_query {kind} r={r} ({b},{n})->{m} ns={k}",
                          lambda: bq.ball_query_cuda(r, k, x, q), lambda: bq.ball_query_plain(r, k, x, q),
                          4 * b * (3 * n + 3 * m + m * k), 9 * scans)
        if kind == "partseg":  # FP1 and FP2 interpolate from the level below
            for lvl in (0, 1):
                x, q = xyz[lvl], xyz[lvl + 1]
                n, m = x.shape[1], q.shape[1]
                check(torch, tallies[nn3.NAME], kind, f"three_nn {kind} ({b},{n},{m})",
                      lambda: nn3.three_nn_cuda(x, q), lambda: nn3.three_nn_plain(x, q),
                      4 * b * (3 * n + 3 * m + 6 * n), 9 * b * n * m)


def shape_train(torch, tmp: pathlib.Path, kind: str, msg: bool, bf16: bool = False,
                epochs: int = SHAPE_EPOCHS, train_batches: int = SHAPE_TRAIN_BATCHES) -> dict:
    """Phase 29: a family's trainer CLI on the card, its launches checked."""
    import math

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = f"{kind} {'MSG' if msg else 'SSG'}{' --bf16' * bf16}"
    argv = ["--batch_size", str(SHAPE_BATCH[kind]), "--npoints", str(SHAPE_NPOINTS), "--epoch", str(epochs),
            "--train_batches", str(train_batches), "--val_batches", str(SHAPE_VAL_BATCHES), "--verbose", "1",
            "--tag", "chip_smoke", "--output_root", str(tmp / f"{kind}_{msg}_{bf16}"), "--device", "cuda",
            *(["--use_msg"] if msg else []), *(["--bf16"] if bf16 else [])]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_dir, last = load_script(f"train_{kind}_torch").main(argv)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches, bf16_launches = kernels.launch_counts(), kernels.bf16_launch_counts()
    print(f"shape train {name}: launches {launches}, bfloat16 launches {bf16_launches}", flush=True)
    check_shape_launches(launches, kind, msg, epochs * (train_batches + SHAPE_VAL_BATCHES), True, f"train {name}")
    check_bf16_launches(bf16_launches, bf16, True, f"shape train {name}")
    scalars = json.loads((run_dir / "all_scalars.json").read_text())
    losses = [row["train_loss"] for row in scalars]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"shape train {name}: train losses {losses}, not {epochs} finite epochs")
    print(f"shape train {name}: {epochs} epochs of {train_batches} steps of {SHAPE_BATCH[kind]} x "
          f"{SHAPE_NPOINTS} in {took:.2f} s; last epoch {last}", flush=True)
    return {"launches": launches, "bf16_launches": bf16_launches, "run_dir": run_dir}


def shape_eval_and_serve(torch, tmp: pathlib.Path, kind: str, msg: bool, run_dir: pathlib.Path) -> dict:
    """Phase 29: eval_shapes_torch.py on a run (metrics in [0, 1]), then
    infer_torch.py --export of it, the artifact's labels on the card equal
    to Predictor's; every run launching the forward path's kernels only."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.engine.export import Predictor, ServingPredictor
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    name = f"{kind} {'MSG' if msg else 'SSG'}"
    total = {k.NAME: 0 for k in kernels.KERNELS}

    def counted(what: str, forwards: int, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_shape_launches(launches, kind, msg, forwards, False, f"{what} {name}")
        for k, v in launches.items():
            total[k] += v
        return out

    b = SHAPE_BATCH[kind]
    metrics = counted("eval_shapes_torch", 2, lambda: load_script("eval_shapes_torch").main(
        ["--folder", str(run_dir), "--batches", "2", "--device", "cuda"]))
    values = [v for k, v in metrics.items() if k not in ("kind", "per_class", "per_category")]
    values += list(metrics.get("per_class", {}).values()) + list(metrics.get("per_category", {}).values())
    if not values or not all(0.0 <= float(v) <= 1.0 for v in values):
        raise RuntimeError(f"eval_shapes_torch {name}: metrics {metrics} outside [0, 1]")
    infer_torch = load_script("infer_torch")
    path = tmp / f"{kind}_{msg}.pt2"
    kernels.reset_launch_counts()
    stats = infer_torch.export(infer_torch.parse_args(
        ["--folder", str(run_dir), "--export", str(path), "--device", "cuda", "--batch_size", str(b)]), run_dir)
    if any(kernels.launch_counts().values()):  # tracing runs the ops' fake versions
        raise RuntimeError(f"exporting the {name} run launched {kernels.launch_counts()}")
    points = shape_batch(kind, 2 * b, 7, augment=False)["points"]
    served = ServingPredictor.from_artifact(path, devices=["cuda"])
    got = counted("the artifact", 2, lambda: served.predict(points))
    want = counted("Predictor", 2, lambda: Predictor.from_run(run_dir, batch_size=b, device="cuda").predict(points))
    shape = (2 * b,) if kind == "cls" else (2 * b, SHAPE_NPOINTS)
    if got.shape != shape or not np.array_equal(got, want):
        raise RuntimeError(f"the {name} artifact's labels {got.shape} differ from Predictor's")
    print(f"shape eval {name}: {metrics}; artifact {stats['mb']:.1f} MB, {stats['nodes']} nodes, traced in "
          f"{stats['export_s']:.1f} s; labels {shape} equal to Predictor's", flush=True)
    return {"launches": total}


def shape_model(torch, kind: str, msg: bool, dropout: float | None = None):
    """A family's model at its recipe from a seeded generator, on the CPU."""
    import dataclasses

    from pointnet2_scannet_tpu_torch import models
    from pointnet2_scannet_tpu_torch.data import shapes

    spec = shape_spec(kind, msg)
    if dropout is not None:
        spec = dataclasses.replace(spec, dropout=dropout)
    gen = torch.Generator().manual_seed(0)
    if kind == "cls":
        return models.PointNet2Cls(SHAPE_COUNT, spec, generator=gen), SHAPE_COUNT
    parts = shapes.num_parts_total(SHAPE_COUNT)
    return models.PointNet2PartSeg(parts, SHAPE_COUNT, spec, generator=gen), parts


def shape_step_card_vs_cpu(torch, kind: str, msg: bool) -> dict:
    """Phase 29: one train step (Dropout off) from the same weights and
    clouds on the card and on the CPU (float32 both, float64 on the CPU as
    the reference), under phase 11's bounds: the loss within
    TRAIN_LOSS_RTOL, the BatchNorm statistics within TRAIN_BN_TOL, the
    card's gradients no further than TRAIN_GRAD_VS_CPU times the CPU's
    float32 ones (or SHAPE_GRAD_FLOOR, the larger) from the float64 ones,
    over all parameters and at the median tensor."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops import tuning

    batch = shape_batch(kind, SHAPE_CHECK_BATCH[kind], 3)
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        model, classes = shape_model(torch, kind, msg, dropout=0.0)
        model.to(device=device, dtype=dtype)
        state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 10, 0.7, 1))
        tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if k != "category"}
        tensors = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}
        if device == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tuning.reset_route_counts()
        res = ts.train_step(state, tensors, num_classes=classes)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            pregather = {k: n for k, n in tuning.route_counts.items() if k[0] == "pregather"}
        out[device, dtype] = (float(res["loss"]), {k: p.grad.cpu() for k, p in model.named_parameters()},
                              {k: b.cpu() for k, b in model.named_buffers() if b.is_floating_point()})
    name = f"{kind} {'MSG' if msg else 'SSG'} ({SHAPE_CHECK_BATCH[kind]} x {SHAPE_NPOINTS})"
    check_shape_launches(launches, kind, msg, 1, True, f"train step {name}")
    if msg and kind == "partseg" and pregather != {("pregather", 128): 2}:
        raise RuntimeError(f"the {name} step took the pregather at {pregather}, not at SA2's two scales")
    ref = out["cpu", torch.float64][1]
    (cpu_loss, cpu_g, cpu_b), (gpu_loss, gpu_g, gpu_b) = out["cpu", torch.float32], out["cuda", torch.float32]
    card, cpu = grad_errors(gpu_g, ref), grad_errors(cpu_g, ref)
    med = len(card) // 2
    card_all, cpu_all = all_l2(gpu_g, ref), all_l2(cpu_g, ref)
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    bn_err = max(float((gpu_b[k] - b).abs().max()) for k, b in cpu_b.items())
    print(f"shape train step {name} card vs CPU: launches {launches}, pregathers {pregather}; loss {gpu_loss} "
          f"vs {cpu_loss} (rel {loss_err:.2e}); BatchNorm stats max abs err {bn_err:.2e}; gradients vs CPU "
          f"float64, over all parameters / median tensor: card {card_all:.2e} / {card[med][0]:.2e}, CPU float32 "
          f"{cpu_all:.2e} / {cpu[med][0]:.2e}", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"shape train step {name}: the card's loss disagrees with the CPU's")
    if not (card_all <= TRAIN_GRAD_VS_CPU * max(cpu_all, SHAPE_GRAD_FLOOR)
            and card[med][0] <= TRAIN_GRAD_VS_CPU * max(cpu[med][0], SHAPE_GRAD_FLOOR)):
        raise RuntimeError(f"shape train step {name}: the card's gradients are further from the float64 "
                           "reference than the CPU's float32 gradients allow")
    for k, b in cpu_b.items():
        torch.testing.assert_close(gpu_b[k], b, rtol=TRAIN_BN_TOL, atol=TRAIN_BN_TOL)
    return {"launches": launches}


def shape_step_time(torch, kind: str, msg: bool, card: str) -> None:
    """Phase 29: the steady train step of a family's recipe on the card."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    model, classes = shape_model(torch, kind, msg)
    model.to("cuda")
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 10, 0.7, 1))
    b = SHAPE_BATCH[kind]
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in shape_batch(kind, b, 5).items() if k != "category"}
    ms = bench_torch.timed_windows(lambda: ts.train_step(state, batch, num_classes=classes), "cuda",
                                   SHAPE_STEPS, SHAPE_WINDOWS, SHAPE_WARM)
    print(f"shape train step {kind} {'MSG' if msg else 'SSG'} steady, {b} x {SHAPE_NPOINTS}: "
          f"{ms[len(ms) // 2]:.3f} ms median of {SHAPE_WINDOWS} windows of {SHAPE_STEPS} (min {ms[0]:.3f}, "
          f"max {ms[-1]:.3f}), {b / ms[len(ms) // 2] * 1e3:.1f} samples/s; {card}", flush=True)


def shape_families(torch, tmp: pathlib.Path, tallies) -> dict:
    """Phase 29; returns the launches of its main-path runs (the CLIs' runs,
    the artifacts' and Predictor's batches, the card's checked steps)."""
    t0 = time.perf_counter()
    card = bench_torch.card_line()
    print(f"phase 29, the shape families on {card}", flush=True)
    check_shape_kernels(torch, tallies)
    total = {k: 0 for k in tallies}
    bf16_total: dict = {}

    def add(run: dict) -> None:
        for k, v in run["launches"].items():
            total[k] += v
        for k, v in run.get("bf16_launches", {}).items():
            bf16_total[k] = bf16_total.get(k, 0) + v

    for kind, msg in SHAPE_VARIANTS:
        run = shape_train(torch, tmp, kind, msg)
        add(run)
        add(shape_eval_and_serve(torch, tmp, kind, msg, run["run_dir"]))
    add(shape_train(torch, tmp, "cls", False, bf16=True, epochs=1, train_batches=2))
    # timed before the CPU steps: their worker threads slow the host's launches
    # (partseg SSG, ~1200 launches in ~20 ms of device time, runs host bound then)
    for kind, msg in SHAPE_VARIANTS:
        shape_step_time(torch, kind, msg, card)
    add(shape_step_card_vs_cpu(torch, "cls", False))
    add(shape_step_card_vs_cpu(torch, "partseg", True))
    print(f"phase 29 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": total, "bf16_launches": bf16_total}


def vote_cloud(torch, b: int, seed: int = 0):
    """b synthetic scenes of VOTE_POINTS points on the card: xyz and the one
    feature channel, height above the scene's lowest point (VoteNet's)."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene

    pts = np.stack([make_synthetic_scene(seed + i, n_points=VOTE_POINTS)[:VOTE_POINTS, :3] for i in range(b)])
    xyz = torch.from_numpy(pts)
    return xyz, (xyz[..., 2:3] - xyz[..., 2:3].amin(dim=1, keepdim=True)).contiguous()


def vote_modules(torch):
    """Phase 30's modules on the CPU, weights from a seeded generator."""
    from pointnet2_scannet_tpu_torch import models

    mods, c = {}, 1
    for k, (npoint, radius, nsample, widths) in enumerate(VOTE_SA):
        mods[f"sa{k + 1}"] = models.SetAbstractionVotes(widths, c, npoint=npoint, radius=radius, nsample=nsample,
                                                         normalize_xyz=True)
        c = widths[-1]
    npoint, radius, nsample, widths = VOTE_PROPOSAL
    mods["proposal"] = models.SetAbstractionVotes(widths, VOTE_SA[1][3][-1], npoint=npoint, radius=radius,
                                                  nsample=nsample, normalize_xyz=True)
    c = 1
    for k, (npoint, radii, nsamples, mlps) in enumerate(VOTE_MSG):
        mods[f"msg{k + 1}"] = models.SetAbstractionMSGVotes(npoint, radii, nsamples, mlps, c)
        c = sum(w[-1] for w in mlps)
    _, radii, nsamples, mlps = VOTE_MSG[1]
    mods["lfp"] = models.LearnableFeaturePropagationMSG(
        mlps, radii, nsamples, VOTE_LFP_POST, c, sum(w[-1] for w in VOTE_MSG[0][3]))
    mods = torch.nn.ModuleDict(mods)
    gen = torch.Generator().manual_seed(0)
    for m in mods.modules():
        if isinstance(m, models.PointwiseMLP):
            m.reset_parameters(gen)
    return mods


def vote_forward(mods, xyz, feats) -> dict:
    """The backbone SA1-SA4, the proposal SA on SA2's seeds, MSG SA1-SA2
    and the LFP from MSG SA2 back onto MSG SA1's points."""
    l_xyz, l_f = xyz, feats
    for k in range(len(VOTE_SA)):
        l_xyz, l_f, _ = mods[f"sa{k + 1}"](l_xyz, l_f)
        if k == 1:
            _, proposal, _ = mods["proposal"](l_xyz, l_f)
    m1_xyz, m1_f, _ = mods["msg1"](xyz, feats)
    m2_xyz, m2_f, _ = mods["msg2"](m1_xyz, m1_f)
    return {"sa4": l_f, "proposal": proposal, "lfp": mods["lfp"](m1_xyz, m2_xyz, m1_f, m2_f)}


def vote_loss(out: dict):
    return sum(v.square().mean() for v in out.values())


def check_vote_kernels(torch, tallies) -> None:
    """Phase 30: a, b, c, d and h at the shapes of phase 30's main path (8
    scenes of 20 000 points), each bit for bit against its plain version,
    timed beside its bound, as phases 3-5 check them."""
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_multi_kernel as bqm
    from pointnet2_scannet_tpu_torch.ops.cuda import fps_kernel as fps
    from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
    from pointnet2_scannet_tpu_torch.ops.cuda.profile_scatter import scan_points

    b = VOTE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(30)
    x0 = vote_cloud(torch, b)[0].to("cuda")
    backward = []

    def level(x, npoint):
        n = x.shape[1]
        check(torch, tallies[fps.NAME], "votes", f"fps votes ({b},{n})->{npoint} plan {tuple(fps.plan(n, x.dtype))}",
              lambda: fps.furthest_point_sample_cuda(x, npoint), lambda: fps.furthest_point_sample_plain(x, npoint),
              4 * b * (3 * n + npoint), 10 * b * (npoint - 1) * n, steps=npoint - 1)
        idx = fps.furthest_point_sample_plain(x, npoint)
        gather_check(torch, tallies[ga.NAME], "votes", f"gather votes centroids ({b},{n},3)x{npoint}", x, idx)
        return ga.gather_plain(x, idx).contiguous()

    def grouping(label, x, c, nidx, grad):
        src = torch.randn((b, x.shape[1], c), generator=gen, device="cuda")
        gather_check(torch, tallies[ga.NAME], "votes", f"gather votes {label} ({b},{x.shape[1]},{c})x{nidx.shape[1]}",
                     src, nidx)
        if grad:
            backward.append((f"votes {label}", nidx, x.shape[1], c))

    seeds = None
    x, c = x0, 1
    for k, (npoint, radius, nsample, widths) in enumerate((*VOTE_SA, VOTE_PROPOSAL)):
        name = "proposal" if k == len(VOTE_SA) else f"SA{k + 1}"
        if name == "proposal":
            x, c = seeds
        q = level(x, npoint)
        n, m = x.shape[1], q.shape[1]
        scans = int(scan_points(torch, x, q, radius, nsample).sum())
        check(torch, tallies[bq.NAME], "votes", f"ball_query votes {name} r={radius} ({b},{n})->{m} ns={nsample}",
              lambda: bq.ball_query_cuda(radius, nsample, x, q), lambda: bq.ball_query_plain(radius, nsample, x, q),
              4 * b * (3 * n + 3 * m + m * nsample), 9 * scans)
        if k == 0:
            check_unique_counts(torch, x, q, radius, nsample)
        nidx = bq.ball_query_plain(radius, nsample, x, q).reshape(b, -1)
        grouping(f"{name} xyz grouping", x, 3, nidx, False)
        grouping(f"{name} feature grouping", x, c, nidx, c != 1)  # SA1 groups the input: no gradient
        if k == 1:
            seeds = (q, widths[-1])
        x, c = q, widths[-1]

    def multi(label, x, q, radii, ks, c, grad):
        n, m = x.shape[1], q.shape[1]
        scans = int(torch.maximum(scan_points(torch, x, q, radii[0], ks[0]),
                                  scan_points(torch, x, q, radii[1], ks[1])).sum())
        check(torch, tallies[bqm.NAME], "votes", f"ball_query_multi votes {label} r={radii} ({b},{n})->{m} ns={ks}",
              lambda: bqm.ball_query_multi_cuda(radii, ks, x, q), lambda: bqm.ball_query_multi_plain(radii, ks, x, q),
              4 * b * (3 * n + 3 * m + m * sum(ks)), 10 * scans)
        for s, nidx in enumerate(bqm.ball_query_multi_plain(radii, ks, x, q)):
            grouping(f"{label} scale {s} grouping", x, 3 + c, nidx.reshape(b, -1), grad)

    xs, c = [x0], 1
    for k, (npoint, radii, ks, mlps) in enumerate(VOTE_MSG):
        q = level(xs[-1], npoint)
        multi(f"MSG SA{k + 1}", xs[-1], q, radii, ks, c, k > 0)
        xs.append(q)
        c = sum(w[-1] for w in mlps)
    multi("LFP", xs[2], xs[1], VOTE_MSG[1][1], VOTE_MSG[1][2], c, True)
    check_scatter(torch, tallies["scatter_add"], "votes", backward)


def check_unique_counts(torch, x, q, radius: float, k: int) -> None:
    """Phase 30: unique_neighbor_count and uniform_resample_neighbors on b's
    rows from the card at SA1's (radius, K), with two queries more a scene:
    one at a cluster of exactly K points (K hits) and one far from every
    point (no hit). Each row must be its distinct hits in ascending order,
    padded with its first hit (all zeros for no hit), which is what the
    count reads; the counts equal the CPU's on the plain version's rows; the
    resampled rows keep each distinct prefix and draw the padding from it."""
    from pointnet2_scannet_tpu_torch import ops
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq

    b, n = x.shape[:2]
    far = x.new_full((b, 1, 3), 1e3)
    cluster = far - 5e2 + radius / 4 * torch.rand((b, k, 3), generator=torch.Generator(device="cuda").manual_seed(3),
                                                  device="cuda")
    xs = torch.cat([x, cluster], dim=1)
    qs = torch.cat([q, cluster[:, :1], far], dim=1)
    idx = bq.ball_query_cuda(radius, k, xs, qs)
    cnt = ops.unique_neighbor_count(idx)
    slots = torch.arange(k, device="cuda")
    prefix = slots < cnt[..., None]
    ascending = (idx[..., 1:] > idx[..., :-1]) | ~prefix[..., 1:]
    padded = torch.where(prefix, idx, idx[..., :1]) == idx
    want = ops.unique_neighbor_count(bq.ball_query_plain(radius, k, xs.cpu(), qs.cpu()))
    out, got = ops.uniform_resample_neighbors(idx, torch.Generator(device="cuda").manual_seed(4))
    drawn = (out[..., :, None] == torch.where(prefix, idx, -1)[..., None, :]).any(-1)
    hist = torch.bincount(cnt.flatten(), minlength=k + 1).cpu()
    print(f"unique counts on b's SA1 rows ({b},{n + k})->{qs.shape[1]} r={radius} K={k}: {int(hist[k])} full, "
          f"{int(hist[1])} of one, {int(hist[2:k].sum())} between; cluster rows {cnt[:, -2].tolist()}, far rows "
          f"{cnt[:, -1].tolist()}", flush=True)
    if not (bool(ascending.all()) and bool(padded.all()) and torch.equal(cnt.cpu(), want)
            and (cnt[:, -2] == k).all() and (cnt[:, -1] == 1).all() and (idx[:, -1] == 0).all()
            and torch.equal(got, cnt) and torch.equal(out[prefix], idx[prefix]) and bool(drawn.all())):
        raise RuntimeError("phase 30: b's rows break unique_neighbor_count's invariant, or the counts or the "
                           "resampling differ from the CPU's")


# phase 30's main-path launches a forward (and its backward): FPS at the
# five SetAbstractionVotes levels and the two MSG levels; the single-radius
# query at the five; the two-radius query at the MSG levels and the LFP;
# the gather at each SetAbstractionVotes level's centroids, grouped xyz and
# grouped features, at each MSG level's centroids and two groupings, at the
# LFP's two; the scatter-add under every grouping of a computed feature
# (SA2-SA4, the proposal, MSG SA2's two, the LFP's two)
VOTE_LAUNCHES = {"furthest_point_sample": 7, "ball_query": 5, "ball_query_multi": 3, "gather": 23,
                 "scatter_add": 8}
# SA1's and MSG1's FPS (20 000 points a row) take the cluster variant, the
# five others one block
VOTE_FPS_VARIANTS = {"block": 5, "cluster": 2}


def vote_step(torch, mods, xyz, feats):
    """One train-mode forward and backward; the outputs and gradients."""
    for p in mods.parameters():
        p.grad = None
    out = vote_forward(mods, xyz, feats)
    vote_loss(out).backward()
    return out


def votenet(torch, tallies) -> dict:
    """Phase 30; returns the launches of its main-path run."""
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    card = bench_torch.card_line()
    print(f"phase 30, the votenet modules at VoteNet's widths on {card}", flush=True)
    check_vote_kernels(torch, tallies)
    xyz, feats = (t.to("cuda") for t in vote_cloud(torch, VOTE_BATCH))
    mods = vote_modules(torch).to("cuda").train()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = vote_step(torch, mods, xyz, feats)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    print(f"votes main path ({VOTE_BATCH} x {VOTE_POINTS}, train forward and backward): launches {launches}, "
          f"FPS variants {kernels.fps_kernel.variant_launches}, outputs {shapes}", flush=True)
    want = {k: VOTE_LAUNCHES.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"phase 30 launched {launches}, not {want}")
    if kernels.fps_kernel.variant_launches != VOTE_FPS_VARIANTS:
        raise RuntimeError(f"phase 30 launched FPS's variants {kernels.fps_kernel.variant_launches}, "
                           f"not {VOTE_FPS_VARIANTS}")
    if not all(bool(v.isfinite().all()) for v in out.values()) or not all(
            p.grad is not None and bool(p.grad.isfinite().all()) for p in mods.parameters()):
        raise RuntimeError("phase 30: non-finite outputs or gradients")
    fwd = bench_torch.timed_windows(lambda: vote_forward(mods, xyz, feats), "cuda", VOTE_STEPS, VOTE_WINDOWS,
                                    VOTE_WARM)
    step = bench_torch.timed_windows(lambda: vote_step(torch, mods, xyz, feats), "cuda", VOTE_STEPS,
                                     VOTE_WINDOWS, VOTE_WARM)
    print(f"votes steady, {VOTE_BATCH} x {VOTE_POINTS}: train forward {fwd[len(fwd) // 2]:.3f} ms (min {fwd[0]:.3f}, "
          f"max {fwd[-1]:.3f}), forward and backward {step[len(step) // 2]:.3f} ms (min {step[0]:.3f}, max "
          f"{step[-1]:.3f}), backward {step[len(step) // 2] - fwd[len(fwd) // 2]:.3f} ms; medians of "
          f"{VOTE_WINDOWS} windows of {VOTE_STEPS}; {card}", flush=True)
    with torch.no_grad():
        mods.eval()
        evals = bench_torch.timed_windows(lambda: vote_forward(mods, xyz, feats), "cuda", VOTE_STEPS,
                                          VOTE_WINDOWS, VOTE_WARM)
    print(f"votes steady eval forward: {evals[len(evals) // 2]:.3f} ms (min {evals[0]:.3f}, max {evals[-1]:.3f})",
          flush=True)
    del mods, out
    vote_card_vs_cpu(torch)
    prep_and_scan(torch)
    print(f"phase 30 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches}


def vote_card_vs_cpu(torch) -> None:
    """Phase 30: one train-mode forward and backward of VOTE_CHECK_BATCH
    scenes on the card against the CPU (float32 both; float64 on the CPU as
    the reference): the outputs within the port's tolerance, the moved
    BatchNorm statistics within TRAIN_BN_TOL, the card's gradients no
    further from the float64 ones than TRAIN_GRAD_VS_CPU times the CPU's
    float32 ones (or SHAPE_GRAD_FLOOR, the larger), over all parameters and
    at the median tensor, as phase 29 holds the families."""
    xyz, feats = vote_cloud(torch, VOTE_CHECK_BATCH, seed=7)
    base = vote_modules(torch)
    res = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        mods = copy.deepcopy(base).to(device=device, dtype=dtype).train()
        out = vote_step(torch, mods, xyz.to(device, dtype), feats.to(device, dtype))
        res[device, dtype] = ({k: v.detach().cpu() for k, v in out.items()},
                              {k: p.grad.cpu() for k, p in mods.named_parameters()},
                              {k: b.cpu() for k, b in mods.named_buffers() if b.is_floating_point()})
    ref = res["cpu", torch.float64][1]
    (cpu_out, cpu_g, cpu_b), (out, g, bufs) = res["cpu", torch.float32], res["cuda", torch.float32]
    out_err = max(float((out[k] - v).abs().max()) for k, v in cpu_out.items())
    bn_err = max(float((bufs[k] - v).abs().max()) for k, v in cpu_b.items())
    card, cpu = grad_errors(g, ref), grad_errors(cpu_g, ref)
    med = len(card) // 2
    card_all, cpu_all = all_l2(g, ref), all_l2(cpu_g, ref)
    print(f"votes step card vs CPU ({VOTE_CHECK_BATCH} x {VOTE_POINTS}): outputs max abs err {out_err:.2e}; "
          f"BatchNorm stats max abs err {bn_err:.2e}; gradients vs CPU float64, over all parameters / median tensor: "
          f"card {card_all:.2e} / {card[med][0]:.2e}, CPU float32 {cpu_all:.2e} / {cpu[med][0]:.2e}", flush=True)
    for k, v in cpu_out.items():
        torch.testing.assert_close(out[k], v, rtol=1e-4, atol=1e-4)
    for k, v in cpu_b.items():
        torch.testing.assert_close(bufs[k], v, rtol=TRAIN_BN_TOL, atol=TRAIN_BN_TOL)
    if not (card_all <= TRAIN_GRAD_VS_CPU * max(cpu_all, SHAPE_GRAD_FLOOR)
            and card[med][0] <= TRAIN_GRAD_VS_CPU * max(cpu[med][0], SHAPE_GRAD_FLOOR)):
        raise RuntimeError("votes step: the card's gradients are further from the float64 reference than the "
                           "CPU's float32 gradients allow")


def write_raw_scan(root: pathlib.Path, sid: str, seed: int):
    """A synthetic raw ScanNet scan of PREP_VERTICES mesh vertices (a
    synthetic scene's points, colours and instances; PREP_FACES random
    triangles) and its label TSV; returns the TSV's path."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.config import NYU_CLASSES
    from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(seed, n_points=PREP_VERTICES)[:PREP_VERTICES]
    n = len(scene)
    scan = root / "scans" / sid
    scan.mkdir(parents=True)
    vert = np.empty(n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for i, name in enumerate(("x", "y", "z", "red", "green", "blue")):
        vert[name] = scene[:, i]
    face = np.empty(PREP_FACES, [("n", "u1"), ("v", "<i4", (3,))])
    face["n"] = 3
    face["v"] = np.random.default_rng(seed).integers(0, n, (PREP_FACES, 3))
    with open(scan / f"{sid}_vh_clean_2.ply", "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 f"element face {PREP_FACES}\nproperty list uchar int vertex_indices\nend_header\n").encode())
        f.write(vert.tobytes())
        f.write(face.tobytes())
    inst = scene[:, 9].astype(np.int64)
    (scan / f"{sid}_vh_clean_2.0.010000.segs.json").write_text(json.dumps({"segIndices": inst.tolist()}))
    groups = [{"id": int(i), "label": f"{NYU_CLASSES[int(scene[inst == i][0, 10])]}_raw", "segments": [int(i)]}
              for i in np.unique(inst)]
    (scan / f"{sid}.aggregation.json").write_text(json.dumps({"segGroups": groups}))
    tsv = root / "labels.tsv"
    tsv.write_text("id\traw_category\tnyu40class\n" + "".join(
        f"{i}\t{c}_raw\t{c}\n" for i, c in enumerate(NYU_CLASSES)))
    return tsv


def prep_and_scan(torch) -> None:
    """Phase 30: scripts/preprocess_torch.py on one synthetic raw scene on
    the card and with --device cpu, the .npy files equal but the normals
    (within PREP_NORMAL_TOL: the card's float64 atomics add in another
    order); then virtual_scan of that scene on the card against the CPU."""
    import numpy as np

    from pointnet2_scannet_tpu_torch.utils.scene_util import virtual_scan

    prep = load_script("preprocess_torch")
    sid = "scene0000_00"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prep_") as tmp:
        tmp = pathlib.Path(tmp)
        tsv = write_raw_scan(tmp, sid, 3)
        arrays, took = {}, {}
        for device in ("cuda", "cpu", "cuda"):
            t0 = time.perf_counter()
            done = prep.main(prep.parse_args(["--scans_dir", str(tmp / "scans"), "--label_tsv", str(tsv),
                                              "--output_dir", str(tmp / device), "--device", device]))
            took[device] = time.perf_counter() - t0  # the card's second run: built and warm
            if done != [sid]:
                raise RuntimeError(f"preprocess_torch.py --device {device} preprocessed {done}")
            arrays[device] = np.load(tmp / device / f"{sid}.npy")
    got, want = arrays["cuda"], arrays["cpu"]
    cols = [0, 1, 2, 3, 4, 5, 9, 10]
    normal_err = float(np.abs(got[:, 6:9] - want[:, 6:9]).max())
    print(f"preprocess_torch.py, one scene of {PREP_VERTICES} vertices and {PREP_FACES} faces: {got.shape}, card "
          f"{took['cuda']:.2f} s, CPU {took['cpu']:.2f} s; normals max abs err {normal_err:.2e}", flush=True)
    if got.shape != want.shape or not np.array_equal(got[:, cols], want[:, cols]) or normal_err > PREP_NORMAL_TOL:
        raise RuntimeError("preprocess_torch.py on the card differs from --device cpu")
    for mode in (-1, 2, 4):
        times = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            idx = virtual_scan(got[:, :3], mode, np.random.default_rng(mode + 7), device=device).cpu()
            times[device] = (time.perf_counter() - t0, idx)
        (t_card, a), (t_cpu, b) = times["cuda"], times["cpu"]
        print(f"virtual_scan mode {mode}: {len(a)} of {len(got)} points on the card in {t_card * 1e3:.1f} ms, "
              f"{len(b)} on the CPU in {t_cpu * 1e3:.1f} ms, {'equal' if torch.equal(a, b) else 'DIFFERENT'}",
              flush=True)
        if not torch.equal(a, b):
            raise RuntimeError(f"virtual_scan mode {mode}: the card's indices differ from the CPU's")


@contextlib.contextmanager
def audited(torch, audit: dict):
    """Every launch of the path's kernel wrappers (PATH_WRAPPERS) held
    against its plain version on the same inputs, bit for bit: on CPU copies
    for the scatter-add (the plain version on the card adds atomically, in no
    fixed order), on the card otherwise. audit counts the checks by kernel
    and lists the kernels that differed under "differ"."""
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels

    saved = []
    for name, module, op in PATH_WRAPPERS:
        mod = getattr(kernels, module)
        cuda_fn, plain_fn = getattr(mod, f"{op}_cuda"), getattr(mod, f"{op}_plain")

        def spy(*args, _cuda=cuda_fn, _plain=plain_fn, _name=name, **kwargs):
            got = _cuda(*args, **kwargs)
            host = _name == "scatter_add"
            want = _plain(*(a.cpu() if host and torch.is_tensor(a) else a for a in args), **kwargs)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            if not all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in pairs):
                audit.setdefault("differ", []).append(_name)
            audit[_name] = audit.get(_name, 0) + 1
            return got

        saved.append((mod, f"{op}_cuda", cuda_fn))
        setattr(mod, f"{op}_cuda", spy)
    try:
        yield audit
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def timed_collectives(torch, times: list):
    """The tp collectives (distributed.all_gather_last, the channel
    all-gather with its host staging, and dist.all_reduce, the
    column-parallel input's backward) each timed on the host clock between two synchronisations of
    the card; times collects the seconds. Returns the undo callable."""
    import torch.distributed as dist

    from pointnet2_scannet_tpu_torch.parallel import distributed as D

    gather, all_reduce = D.all_gather_last, dist.all_reduce

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return call

    D.all_gather_last, dist.all_reduce = timed(gather), timed(all_reduce)

    def undo():
        D.all_gather_last, dist.all_reduce = gather, all_reduce
    return undo


def tp_step(torch, state, batch, grid) -> dict:
    """One train step of a rank on the grid, audited and counted: the loss,
    the gradients and BatchNorm statistics gathered whole, the updated
    parameters gathered whole, the launches, the audit, and this rank's
    numel of every leaf and Adam moment."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel.mesh import gather_leaf, gather_train_state

    audit = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with audited(torch, audit):
        res = ts.train_step(state, batch, num_classes=20, group=grid.dp_group)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    m, split = state.model, state.shardings

    def whole(k, t):
        return (gather_leaf(t, grid) if split[k] else t.detach()).cpu()

    full = gather_train_state(state, grid)
    return {"loss": float(res["loss"]), "launches": launches, "audit": audit,
            "grads": {k: whole(k, p.grad) for k, p in m.named_parameters()},
            "stats": {k: whole(k, b) for k, b in m.named_buffers() if b.is_floating_point()},
            "params": {k: full["model"][k] for k, _ in m.named_parameters()},
            "numel": {k: t.numel() for k, t in [*m.named_parameters(), *m.named_buffers()]},
            "adam": {k: {n: v.numel() for n, v in state.optimizer.state[p].items() if n != "step"}
                     for k, p in m.named_parameters()},
            "shardings": dict(split)}


def tp_rank(rank: int, port: int, tmp: str) -> None:
    """Phase 31 (a)-(e) on one of TP_RANKS gloo ranks sharing cuda:0; writes
    what it got to <tmp>/rank<rank>.pt."""
    import torch

    sys.path.insert(0, str(ROOT))
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.checkpoint import load_state_dict, restore_checkpoint
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel.distributed import initialize_distributed, shutdown
    from pointnet2_scannet_tpu_torch.parallel.mesh import gather_train_state, grid_context, shard_train_state

    tmp = pathlib.Path(tmp)
    ctx = initialize_distributed(f"127.0.0.1:{port}", TP_RANKS, rank, device="cuda", backend="gloo")
    grid = grid_context(ctx, TP_RANKS).grid
    batch = train_batch(torch, TP_BATCH, "cuda")
    out = {}

    def fresh(kind):
        state = bench_torch.fresh_state(kind, "cuda", 0.0, bn_group=grid.dp_group, tp_group=grid.tp_group)
        shard_train_state(state, grid)
        return state

    for kind in KINDS:  # (a)-(c)
        state = fresh(kind)
        out[kind] = tp_step(torch, state, batch, grid)
        if kind == "ssg":  # (e)
            step = lambda: ts.train_step(state, batch, num_classes=20, group=grid.dp_group)  # noqa: E731
            out["step_ms"] = dp_timed(torch, step, TP_WARM, TP_TIMED)
            times = []
            undo = timed_collectives(torch, times)
            try:
                marked = dp_timed(torch, step, 0, TP_TIMED)
            finally:
                undo()
            out["instrumented_ms"], out["collective_ms"] = marked, sum(times) * 1e3
            out["collectives"] = len(times) // TP_TIMED
        del state
        torch.cuda.empty_cache()
    ctx.barrier("steps done")
    # (d) the Solver through train_torch, each rank with an output root of its own
    train_torch = load_script("train_torch")
    argv = ["--synthetic", "--synthetic_scenes", str(DP_SCENES), "--batch_size", str(DP_BATCH), "--npoints",
            str(NPOINTS), "--use_color", "--use_normal", "--verbose", "1", "--device", "cuda", "--num_devices",
            str(TP_RANKS), "--tp", str(TP_RANKS)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_dir, _ = train_torch.train(train_torch.parse_args([
        *argv, "--epoch", str(TP_EPOCHS), "--tag", "chip_smoke_tp", "--output_root", str(tmp / f"train{rank}")]), ctx)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["solver_launches"] = kernels.launch_counts()
    check_launches(out["solver_launches"], "ssg", True, f"tp 2 Solver run, rank {rank}")
    run_dir = pathlib.Path(ctx.broadcast_object(str(run_dir)))  # the coordinator's
    out["run_dir"] = str(run_dir)
    if ctx.is_coordinator:  # a resume's logger starts the file anew
        out["scalars"] = json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    state = fresh("ssg")
    restore_checkpoint(run_dir, "model_last", state, 0, grid)
    back = gather_train_state(state, grid)["model"]
    saved = load_state_dict(run_dir, "model_last")
    out["restore_differs"] = [k for k, v in saved.items() if not torch.equal(back[k], v)]
    del state
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    train_torch.train(train_torch.parse_args([
        "--resume", str(run_dir), "--epoch", str(TP_EPOCHS + 1), "--synthetic", "--device", "cuda", "--num_devices",
        str(TP_RANKS), "--tp", str(TP_RANKS), "--verbose", "1"]), ctx)
    out["resume_launches"] = kernels.launch_counts()
    check_launches(out["resume_launches"], "ssg", True, f"tp 2 resume, rank {rank}")
    torch.save(out, tmp / f"rank{rank}.pt")
    shutdown(ctx)


def tensor_parallel(torch, tmp: pathlib.Path) -> dict:
    """Phase 31; returns the launches of its main-path runs (both ranks'
    steps, Solver runs and resumes)."""
    import math

    import numpy as np

    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.parallel.distributed import free_port, spawn
    from pointnet2_scannet_tpu_torch.parallel.mesh import leaf_split

    t_phase = time.perf_counter()
    card = bench_torch.card_line()
    print(f"phase 31, tensor parallelism: dp 1 x tp {TP_RANKS}, {TP_RANKS} gloo ranks sharing cuda:0, SSG and "
          f"MSG at {TP_BATCH} x {NPOINTS} x 9, on {card}", flush=True)
    # the single-process references on the card, their launches and phase 11's noise
    batch = train_batch(torch, TP_BATCH, "cuda")
    refs, plain_ms = {}, None
    for kind in KINDS:
        state = bench_torch.fresh_state(kind, "cuda", 0.0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        refs[kind] = dp_step_out(torch, state, ts.train_step(state, batch, num_classes=20))
        torch.cuda.synchronize()
        refs[kind]["launches"] = kernels.launch_counts()
        refs[kind]["numel"] = {k: t.numel() for k, t in [*state.model.named_parameters(),
                                                         *state.model.named_buffers()]}
        refs[kind]["shapes"] = {k: tuple(t.shape) for k, t in [*state.model.named_parameters(),
                                                               *state.model.named_buffers()]}
        if kind == "ssg":
            plain_ms = dp_timed(torch, lambda: ts.train_step(state, batch, num_classes=20), TP_WARM, TP_TIMED)
        refs[kind]["noise"] = f32_noise(torch, kind)
        del state
    del batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(tp_rank, TP_RANKS, (free_port(), str(tmp)), timeout=900)
    spawned_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False, map_location="cpu") for r in range(TP_RANKS)]
    total = {k: 0 for k in kernels.launch_counts()}
    for kind in KINDS:
        ref = refs[kind]
        for r, out in enumerate(ranks):
            got = out[kind]
            # (a)
            dp_gates(torch, got, ref, ref["noise"], f"tensor parallel (a), {kind.upper()}, rank {r} of dp 1 x tp "
                     f"{TP_RANKS}, one train step of {TP_BATCH} x {NPOINTS}")
            # (b)
            split = {k: leaf_split(shape, TP_RANKS) for k, shape in ref["shapes"].items()}
            if got["shardings"] != split:
                raise RuntimeError(f"tensor parallel (b), {kind}: the layout is not the leaf rule's")
            wrong = [k for k, n in ref["numel"].items() if got["numel"][k] != (n // TP_RANKS if split[k] else n)]
            wrong += [k for k, m in got["adam"].items() if set(m.values()) != {got["numel"][k]}]
            if wrong:
                raise RuntimeError(f"tensor parallel (b), {kind}: leaves not this rank's slice: {wrong[:5]}")
            held, whole = sum(got["numel"].values()), sum(ref["numel"].values())
            # (c)
            audit = dict(got["audit"])
            differ = audit.pop("differ", [])
            launches = got["launches"]
            if launches != ref["launches"] or differ or audit != {k: n for k, n in launches.items() if n}:
                raise RuntimeError(f"tensor parallel (c), {kind}, rank {r}: launches {launches} against the "
                                   f"single-process step's {ref['launches']}, audited {audit}, differing {differ}")
            print(f"tensor parallel (b)-(c), {kind.upper()}, rank {r}: {sum(split.values())} of {len(split)} "
                  f"leaves split, the Adam moments with them; the rank holds {held} of {whole} elements of the "
                  f"model; launches {launches}, each bit-equal to its plain version", flush=True)
            for k, n in launches.items():
                total[k] += n
        first, second = ranks[0][kind]["params"], ranks[1][kind]["params"]
        differ = [k for k, v in first.items() if not torch.equal(v, second[k])]
        if differ:
            raise RuntimeError(f"tensor parallel (a), {kind}: the ranks' gathered states differ ({differ[:5]})")
    # (d)
    run_dir = pathlib.Path(ranks[0]["run_dir"])
    if run_dir.parent != tmp / "train0" or (tmp / "train1").exists():
        raise RuntimeError(f"tensor parallel (d): rank 0 ran in {run_dir}, or rank 1 wrote a run dir")
    first, resumed = ranks[0]["scalars"], json.loads((run_dir / "tensorboard" / "all_scalars.json").read_text())
    losses = [v for scalars in (first, resumed) for part in ("train/loss", "val/loss") for _, v in scalars[part]]
    epochs = [e for scalars in (first, resumed) for e, _ in scalars["train/loss"]]
    if epochs != list(range(TP_EPOCHS + 1)) or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"tensor parallel (d): losses {losses} of epochs {epochs}, not {TP_EPOCHS + 1} epochs "
                           "of finite values")
    config = json.loads((run_dir / "config.json").read_text())
    if config["train"]["tp"] != TP_RANKS or any(out["restore_differs"] for out in ranks):
        raise RuntimeError(f"tensor parallel (d): config tp {config['train']['tp']}, or the restored state "
                           f"differs from the file: {[out['restore_differs'][:3] for out in ranks]}")
    for out in ranks:
        for part in ("solver_launches", "resume_launches"):
            for k, n in out[part].items():
                total[k] += n
    eval_torch = load_script("eval_torch")
    kernels.reset_launch_counts()
    report = eval_torch.evaluate(eval_torch.parse_args([
        "--folder", str(run_dir), "--device", "cuda", "--synthetic", "--synthetic_scenes", str(DP_EVAL_SCENES),
        "--batch_size", str(BATCH)]))
    eval_launches = kernels.launch_counts()
    check_launches(eval_launches, "ssg", False, "tp-1 evaluation of the tp 2 run")
    for k, n in eval_launches.items():
        total[k] += n
    if not math.isfinite(report.voxel_miou):
        raise RuntimeError(f"tensor parallel (d): the tp-1 evaluation's voxel mIoU is {report.voxel_miou}")
    print(f"tensor parallel (d): train_torch.train --tp {TP_RANKS} on {TP_RANKS} ranks, {DP_SCENES} scenes, batch "
          f"{DP_BATCH}, {TP_EPOCHS} epochs in {[round(out['train_s'], 2) for out in ranks]} s, then a --resume at "
          f"--tp {TP_RANKS} for epoch {TP_EPOCHS + 1}; losses {losses}; model_last restored onto the grid gathers "
          f"back equal; a tp-1 eval_torch.evaluate of {DP_EVAL_SCENES} scenes read it (voxel mIoU {report.voxel_miou:.4f}); "
          f"Solver launches {[out['solver_launches'] for out in ranks]}", flush=True)
    # (e)
    for r, out in enumerate(ranks):
        ms, marked = np.median(out["step_ms"]), sum(out["instrumented_ms"])
        print(f"tensor parallel (e), rank {r}: SSG step of {TP_BATCH} x {NPOINTS} on dp 1 x tp {TP_RANKS}, ms median "
              f"(min, max) of {TP_TIMED}: {ms:.2f} ({out['step_ms'][0]:.2f}, {out['step_ms'][-1]:.2f}); the "
              f"single-process step {np.median(plain_ms):.2f} ({plain_ms[0]:.2f}, {plain_ms[-1]:.2f}); {TP_TIMED} "
              f"steps with each of their {out['collectives']} tp collectives a step timed between "
              f"synchronisations {[round(t, 2) for t in out['instrumented_ms']]}, in all {marked:.2f}, of which "
              f"the collectives {out['collective_ms']:.2f} (share {out['collective_ms'] / marked:.3f}); host "
              f"clock; {card}", flush=True)
    print(f"phase 31 took {time.perf_counter() - t_phase:.1f} s (the spawned ranks {spawned_s:.1f} s); launches "
          f"on its main path (both ranks' steps, Solver runs and resumes, the evaluation) {total}", flush=True)
    return {"launches": total}


def interp_bound(torch, want, dtype) -> float:
    """Phase 32 (a)'s bound on a difference: 1e-5 of the largest |value| in
    float32, 2 bfloat16 ulps of it in bfloat16."""
    import math

    top = float(want.double().abs().max())
    if dtype == torch.float32:
        return INTERP_F32_TOL * top
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def interpolation_forms(torch, tallies) -> None:
    """Phase 32 (a): dense, cached and fast at SSG's four FP shapes (B 32,
    bench_hotops_torch.FP_LEVELS), in float32 and bfloat16 (the points; the
    weights float32, as the model's), forward and the points' gradient of a
    random cotangent, held against the same function on the CPU on the
    first INTERP_CPU_ROWS batch rows (float32 1e-5 of the largest |value|,
    bfloat16 2 ulps of it) and, in float32, against the gather form on the
    card at the same bound; fast launches one d a forward and no h, dense
    and cached neither, and that d is held against its plain version at
    the fast forward's shape (gather_check); each form's
    forward-and-backward ms beside the gather form's."""
    from pointnet2_scannet_tpu_torch import ops
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops.interpolate import interpolation

    levels = load_script("bench_hotops_torch").FP_LEVELS
    gen = torch.Generator(device="cuda").manual_seed(32)
    rows = INTERP_CPU_ROWS

    def fwd_bwd(form, feats, idx, w, g):
        x = feats.clone().requires_grad_(True)
        out = interpolation(form)(x, idx, w)
        return out.detach(), torch.autograd.grad(out, x, g.to(out.dtype))[0]

    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for level, n, m, c in levels:
            _, idx = ops.three_nn(torch.rand((BATCH, n, 3), generator=gen, device="cuda"),
                                  torch.rand((BATCH, m, 3), generator=gen, device="cuda"))
            w = torch.rand((BATCH, n, 3), generator=gen, device="cuda") + 0.1
            w = w / w.sum(-1, keepdim=True)
            feats = torch.randn((BATCH, m, c), generator=gen, device="cuda").to(dtype)
            g = torch.randn((BATCH, n, c), generator=gen, device="cuda")
            card_args = (feats, idx, w, g)
            cpu_args = tuple(a[:rows].cpu() for a in card_args)
            gather = fwd_bwd("gather", *card_args)
            line = []
            for form in ("dense", "cached", "fast"):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                card = fwd_bwd(form, *card_args)
                torch.cuda.synchronize()
                launches = kernels.launch_counts()
                want_d = int(form == "fast")
                if launches["gather"] != want_d or launches["scatter_add"] != 0:
                    raise RuntimeError(f"interpolation {form} {dname} {level}: launches {launches}, "
                                       f"not {want_d} gather and no scatter_add")
                cpu = fwd_bwd(form, *cpu_args)
                pairs = {"vs CPU out": (card[0][:rows].cpu(), cpu[0]), "vs CPU grad": (card[1][:rows].cpu(), cpu[1])}
                if dtype == torch.float32:
                    pairs.update({"vs gather out": (card[0], gather[0]), "vs gather grad": (card[1], gather[1])})
                errs = {}
                for what, (a, e) in pairs.items():
                    errs[what] = float((a.double() - e.double()).abs().max())
                    if not errs[what] <= interp_bound(torch, e, dtype):
                        raise RuntimeError(f"interpolation {form} {dname} {level} {what}: {errs[what]} > "
                                           f"{interp_bound(torch, e, dtype)}")
                ms = cuda_ms(lambda form=form: fwd_bwd(form, *card_args), torch)
                line.append(f"{form} {ms:.4f} ms (" + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                            + f"; launches d {launches['gather']}, h {launches['scatter_add']})")
            gather_check(torch, tallies["gather"], f"fast {dname}", f"gather fast {dname} {level} (B {BATCH}, "
                         f"J {3 * n}, N {m}, C {c})", feats, idx.reshape(BATCH, 3 * n))
            gather_ms = cuda_ms(lambda: fwd_bwd("gather", *card_args), torch)
            print(f"interpolation {dname} {level} (B {BATCH}, n {n} <- m {m}, C {c}) forward and backward: "
                  + "; ".join(line) + f"; gather {gather_ms:.4f} ms; {bench_torch.card_line()}", flush=True)
            del gather, card, card_args


def check_sorted_scatter(torch, tally, dtype=None) -> None:
    """Phase 32 (b): h's card-wide sort route (scatter_add_sorted_cuda) at
    SSG's SA2-SA4 grouping backwards (B 32: J = 32 x M, the [xyz | features]
    payload, or bfloat16's packed [xyz_hi | xyz_lo | features] one; indices
    from the ball query of level_clouds' points), bit for bit against its
    plain version on CPU copies, a second launch and the block route;
    timed beside the block route (counterpart), the plain version on the
    card and scatter_add_."""
    from pointnet2_scannet_tpu_torch.ops.cuda import ball_query_kernel as bq
    from pointnet2_scannet_tpu_torch.ops.cuda import build
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss

    xyz, _, _ = level_clouds(torch)
    gen = torch.Generator(device="cuda").manual_seed(2)
    path = "ssg sort" + (" bf16" if dtype is not None else "")
    for level, (n, m, r, feat) in enumerate(LEVELS[1:], start=2):
        idx = bq.ball_query_cuda(r, NSAMPLE, xyz[level - 1], xyz[level]).reshape(BATCH, m * NSAMPLE)
        c = feat + (BF16_XYZ if dtype is not None else 3)
        j = idx.shape[1]
        g = torch.randn((BATCH, j, c), generator=gen, device="cuda")
        g *= 10.0 ** (torch.rand((BATCH, j, 1), generator=gen, device="cuda") * 6 - 3)
        g32 = g if dtype is None else g.to(dtype).float()
        g = g if dtype is None else g.to(dtype)
        before = dict(sc.route_launches)
        got, again, block = sc.scatter_add_sorted_cuda(idx, g, n), sc.scatter_add_sorted_cuda(idx, g, n), \
            sc.scatter_add_cuda(idx, g, n)
        if sc.route_launches != {"block": before["block"] + 1, "sort": before["sort"] + 2}:
            raise RuntimeError(f"h's routes counted {sc.route_launches} after {before}: not 2 sort and 1 block")
        want = sc.scatter_add_plain(idx.cpu(), g.cpu(), n)
        err = float((got.cpu().double() - want.double()).abs().max())
        equal = torch.equal(got.cpu(), want) and torch.equal(again, got) and torch.equal(block, got)
        index = idx.long().unsqueeze(-1).expand(BATCH, j, c)
        ms = cuda_ms(lambda: sc.scatter_add_sorted_cuda(idx, g, n), torch)
        block_ms = cuda_ms(lambda: sc.scatter_add_cuda(idx, g, n), torch)
        plain_ms = cuda_ms(lambda: sc.scatter_add_plain(idx, g, n), torch)
        library_ms = cuda_ms(lambda: torch.zeros((BATCH, n, c), device="cuda").scatter_add_(1, index, g32), torch)
        nbytes, nops = 4 * BATCH * j + g.element_size() * (BATCH * j * c + BATCH * n * c), BATCH * j * c
        tally.add(path, ms, plain_ms, err, nbytes, nops, library_ms, counterpart_ms=block_ms)
        bound, by = bound_ms(nbytes, nops)
        plan = ss.sort_plan(BATCH, n, j, c, build.sm_count(g))
        print(f"kernel scatter_add sort route SA{level} (B={BATCH}, J={j}, N={n}, C={c}, {g.dtype}): {ms:.4f} ms "
              f"(block route {block_ms:.4f} ms: {ms / block_ms:.2f}x), plan {tuple(plan)}, plain on the card "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound:.4f} ms ({by}), max_abs_err vs CPU "
              f"plain {err}, {'equal' if equal else 'DIFFERENT'} to it, a second launch and the block route",
              flush=True)
        if not equal:
            raise RuntimeError(f"h's sort route at SA{level}: differs (max_abs_err {err})")


def step_out(torch, state, res) -> dict:
    """What phase 32 compares of a train step: the loss, every gradient,
    BatchNorm statistics and parameters after the update."""
    m = state.model
    return {"loss": res["loss"].detach().clone(), **{f"grad.{k}": p.grad.clone() for k, p in m.named_parameters()},
            **{f"state.{k}": v.detach().clone() for k, v in m.state_dict().items()}}


def segsum_steps(torch) -> dict:
    """Phase 32 (b): one SSG train step at 32 x 8192 (Dropout 0.5, one
    seed) with group_segsum on against the default step, float32 and
    bfloat16: loss, gradients, BatchNorm statistics and the updated
    parameters bit for bit; the segsum step launches h's sort route once
    for each grouping backward (SA2-SA4: 3) and its block route for the FP
    gathers (4), the default step 7 block launches; a CUDA graph of 2 steps
    with the switch on bit-equal to 2 eager steps; the step's ms beside the
    default's. Returns the launches of the steps."""
    from pointnet2_scannet_tpu_torch.data.pipeline import HostGroup
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
    from pointnet2_scannet_tpu_torch.parallel.step import make_fused_train_step

    batch = train_batch(torch, BATCH, "cuda")
    launches = dict.fromkeys(kernels.launch_counts(), 0)
    for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        outs, routes, states = {}, {}, {}
        for setting in (False, True):
            with switches(group_segsum=setting):
                states[setting] = bench_torch.fresh_state("ssg", "cuda", 0.5, dtype=dtype)
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                outs[setting] = step_out(torch, states[setting], ts.train_step(states[setting], batch, num_classes=20))
                torch.cuda.synchronize()
                routes[setting] = dict(sc.route_launches)
                for k, n in kernels.launch_counts().items():
                    launches[k] += n
        differ = [k for k, v in outs[False].items() if not torch.equal(outs[True][k], v)]
        print(f"group_segsum SSG step {dname} (B {BATCH} x {NPOINTS}): h routes default {routes[False]}, segsum "
              f"{routes[True]}; {len(outs[False])} tensors (loss, gradients, parameters, BatchNorm statistics), "
              f"{len(differ)} differ", flush=True)
        if differ:
            raise RuntimeError(f"group_segsum step {dname}: differs from the default step in {differ[:6]}")
        if routes != {False: {"block": 7, "sort": 0}, True: {"block": 4, "sort": 3}}:
            raise RuntimeError(f"group_segsum step {dname}: h's routes {routes}")
        times = {s: [] for s in (False, True)}
        for setting in (False, True, True, False):
            with switches(group_segsum=setting):
                times[setting].append(cuda_ms(lambda: ts.train_step(states[setting], batch, num_classes=20), torch))
        print(f"group_segsum SSG step {dname} ms: default " + " / ".join(f"{t:.3f}" for t in times[False])
              + "; segsum " + " / ".join(f"{t:.3f}" for t in times[True]) + f"; {bench_torch.card_line()}",
              flush=True)

    with switches(group_segsum=True):  # a graph of 2 steps against 2 eager ones
        eager, graph = (bench_torch.fresh_state("ssg", "cuda", 0.5) for _ in range(2))
        batches = fused_batches(2, BATCH, 32)
        want = [ts.train_step(eager, {k: torch.from_numpy(v).cuda() for k, v in b.items()}, num_classes=20)
                for b in batches]
        fused = make_fused_train_step(graph.model, None, num_classes=20, log=print)
        kernels.reset_launch_counts()
        got = fused(graph, HostGroup(batches, pin=True))
        torch.cuda.synchronize()
        capture_routes = dict(sc.route_launches)
        for k, n in kernels.launch_counts().items():
            launches[k] += n
    differ = state_differs(torch, whole_state(graph), whole_state(eager))
    same = torch.equal(got["loss"], torch.stack([w["loss"] for w in want])) and torch.equal(
        got["confusion"], torch.stack([w["confusion"] for w in want]))
    print(f"group_segsum graph of 2 steps (mode {fused.mode}): h routes of warm-up and capture {capture_routes}; "
          f"losses {got['loss'].tolist()} vs eager {[float(w['loss']) for w in want]}; {len(differ)} tensors "
          f"differ", flush=True)
    if fused.mode != "graph" or not same or differ:
        raise RuntimeError(f"group_segsum graph of 2 steps differs from 2 eager steps ({differ[:6]})")
    if capture_routes["sort"] != 3 * 2 * 2 or capture_routes["block"] != 4 * 2 * 2:  # warm-up and capture
        raise RuntimeError(f"group_segsum graph: h's routes {capture_routes}")
    return launches


def serve_switches(torch) -> dict:
    """Phase 32 (c), (d): SSG serve batches (32 x 8192, eval) under the
    switches against the default's: fps_pallas and ball_query_pallas False
    give bit-equal logits with the same a and b launches and "xla" routes;
    interpolate_dense within 1e-4; pregather_dense True pregathers every
    SA level with features, within 1e-4; at mv131, pregather_dense False
    turns SA1's pregather off, within 1e-4. Returns the launches."""
    import collections

    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops import tuning

    launches = dict.fromkeys(kernels.launch_counts(), 0)

    def forward(state, batch, **fields):
        model = state.model.eval()
        with switches(**fields), torch.inference_mode():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tuning.reset_route_counts()
            out = model(batch["points"])
            torch.cuda.synchronize()
        run = kernels.launch_counts()
        for k, n in run.items():
            launches[k] += n
        return out, run, dict(tuning.route_counts)

    def pregathers(routes):
        return {k[1]: n for k, n in routes.items() if k[0] == "pregather"}

    for channels in (6, MV131):
        batch = train_batch(torch, BATCH, "cuda", input_channels=channels)
        state = bench_torch.fresh_state("ssg", "cuda", 0.5, input_channels=channels)
        base, base_run, base_routes = forward(state, batch)
        cases = ({"fps_pallas": False, "ball_query_pallas": False}, {"interpolate_dense": True},
                 {"pregather_dense": True}) if channels == 6 else ({"pregather_dense": False},)
        for fields in cases:
            out, run, routes = forward(state, batch, **fields)
            err = float((out - base).abs().max())
            what = f"SSG serve batch ({channels} input channels) under {fields}"
            print(f"{what}: logits max abs err {err:.3e} vs default; launches {run} (default {base_run}); "
                  f"routes {routes}", flush=True)
            if "fps_pallas" in fields:
                auto = collections.Counter(
                    [("fps", tuning.fps_route(n)) for n, _, _, _ in LEVELS]
                    + [("ball_query", tuning.ball_query_route(n, m)) for n, m, _, _ in LEVELS])
                ok = (torch.equal(out, base) and run == base_run and routes[("fps", "xla")] == 4
                      and routes[("ball_query", "xla")] == 4
                      and {k: n for k, n in base_routes.items() if k[0] in ("fps", "ball_query")} == auto)
            elif "interpolate_dense" in fields:
                ok = (err <= LOGIT_ATOL and routes[("interpolate", "dense")] == 4
                      and run["gather"] == base_run["gather"] - 4)
            elif fields["pregather_dense"]:
                ok = err <= LOGIT_ATOL and pregathers(routes) == {1024: 1, 256: 1, 64: 1, 16: 1} \
                    and not pregathers(base_routes)
            else:
                ok = err <= LOGIT_ATOL and not pregathers(routes) and pregathers(base_routes) == {1024: 1}
            if not ok:
                raise RuntimeError(f"{what}: the gates of phase 32 (c) / (d) failed")
    return launches


def dense_step_times(torch) -> None:
    """Phase 32 (c): the SSG train step at 32 x 8192 (float32, bfloat16)
    under interpolate_dense beside the default's, CUDA events, in turns
    default, dense, dense, default."""
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    batch = train_batch(torch, BATCH, "cuda")
    for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        state = bench_torch.fresh_state("ssg", "cuda", 0.5, dtype=dtype)
        times = {False: [], True: []}
        for setting in (False, True, True, False):
            with switches(interpolate_dense=setting):
                times[setting].append(cuda_ms(lambda: ts.train_step(state, batch, num_classes=20), torch))
        print(f"interpolate_dense SSG step {dname} (B {BATCH} x {NPOINTS}) ms: default "
              + " / ".join(f"{t:.3f}" for t in times[False]) + "; dense "
              + " / ".join(f"{t:.3f}" for t in times[True]) + f"; {bench_torch.card_line()}", flush=True)


def op_switches(torch, tallies) -> dict:
    """Phase 32: the op-lowering switches on the card (the module
    docstring); returns the launches of its model runs."""
    t0 = time.perf_counter()
    interpolation_forms(torch, tallies)
    print(f"phase 32 (a) done after {time.perf_counter() - t0:.1f} s", flush=True)
    for dtype in (None, torch.bfloat16):
        check_sorted_scatter(torch, tallies["scatter_add"], dtype)
    launches = segsum_steps(torch)
    print(f"phase 32 (b) done after {time.perf_counter() - t0:.1f} s", flush=True)
    for k, n in serve_switches(torch).items():
        launches[k] += n
    with switches(interpolate_dense=True):
        train_step_card_vs_cpu(torch, "ssg", "dense")
    dense_step_times(torch)
    print(f"phase 32 (c), (d) done after {time.perf_counter() - t0:.1f} s", flush=True)
    load_script("bench_fp_torch").main(["--dtype", "f32"])
    load_script("bench_pregather_torch").main(["--quick"])
    print(f"phase 32 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches}


def lap(t0: float, what: str) -> None:
    """A line of the script's wall time so far, where a group of phases ends."""
    print(f"time: {what} done after {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import pointnet2_scannet_tpu_torch  # noqa: F401  (switches TF32 off)
    from pointnet2_scannet_tpu_torch.ops import cuda as kernels
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    kind = torch.cuda.get_device_name(0)
    card = bench_torch.card_line()
    print(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {card}", flush=True)

    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    nvcc = f"{build.build_seconds:.1f} s in nvcc" if build.build_seconds is not None else "already built"
    print(f"build: {took:.1f} s ({nvcc}) -> {build.library_path().name}", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "entry function" in line:
            print(f"  {line.strip()}")
    lap(start, "phases 1-2")

    tallies = {k.NAME: Tally(k) for k in kernels.KERNELS}
    xyz, fps_idx, input_feats = level_clouds(torch)
    backward = check_kernels(torch, tallies, xyz, fps_idx, input_feats)
    check_scatter(torch, tallies["scatter_add"], "ssg", backward)
    check_scatter(torch, tallies["scatter_add"], "skew", skewed_row(torch))
    check_mv131_gathers(torch, tallies, xyz)
    multi_idx = check_multi(torch, tallies, xyz)
    backward = check_msg_gathers(torch, tallies, xyz, input_feats, multi_idx)
    check_scatter(torch, tallies["scatter_add"], "msg", backward)
    time_pregather(torch)
    check_switched_kernels(torch, tallies, xyz, fps_idx, input_feats)
    check_fused(torch, tallies)
    check_p3_fps(torch, tallies["furthest_point_sample"])
    check_p3_queries(torch, tallies)
    check_bf16_kernels(torch, tallies, xyz, multi_idx)  # phase 23's kernel checks
    bf16_tallies = {k.NAME: Tally(k, f"{k.NAME}_bf16") for k in (
        kernels.gather_smem_kernel, kernels.scatter_smem_kernel, kernels.gather_split_kernel)}
    check_p1_bf16_kernels(torch, bf16_tallies, xyz, multi_idx)  # phase 24's kernel checks
    del backward, multi_idx, xyz, fps_idx, input_feats
    lap(start, "phases 3-8 and 23-24's kernel checks")
    for name, t in [*tallies.items(), *((t.name, t) for t in bf16_tallies.values())]:
        for path, p in t.paths.items():
            print(f"kernel {name} over the {path.upper()} shapes: " + ", ".join(
                f"{k} {v:.4f}" for k, v in p.items() if v is not None), flush=True)
    gathers = tallies["gather"].paths
    for what, paths in (("SSG's 8 (centroids, groupings)", ("ssg",)),
                        ("SSG's 12 (and FP0-FP3)", ("ssg", "ssg fp")), ("MSG's 16", ("msg",)),
                        ("SSG's 8 bfloat16 (groupings, FP0-FP3)", ("ssg bf16",)),
                        ("MSG's 12 bfloat16 (groupings, FP0-FP3)", ("msg bf16",))):
        print(f"kernel gather over {what}: " + ", ".join(
            f"{k} {sum(gathers[p][k] for p in paths):.4f}" for k in ("ms", "library_ms", "bytes")),
            flush=True)

    launches = {name: 0 for name in tallies}
    bf16_launches = dict.fromkeys(kernels.bf16_launch_counts(), 0)

    def tally(run: dict) -> None:
        for name, n in run["launches"].items():
            launches[name] += n
        for name, n in run.get("bf16_launches", {}).items():
            bf16_launches[name] += n

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        host_train = {}
        for model_kind in KINDS:
            tally(serve(torch, tmp, model_kind))
            host_train[model_kind] = train_cli(torch, tmp, model_kind)
            tally(host_train[model_kind])
        with switches(**MXU_CONFIG):  # phase 12: P1
            tally(serve(torch, tmp, "ssg", "mxu"))
            tally(train_cli(torch, tmp, "ssg", "mxu"))
        for npoints in P2_NPOINTS:  # phase 13: P2
            tally(train_cli(torch, tmp, "ssg", npoints=npoints))
            tally(serve(torch, tmp, "ssg", npoints=npoints))
        print_columns()
        for model_kind in KINDS:  # phase 16: whole scenes
            tally(train_cli(torch, tmp, model_kind, wholescene=True))
        # phase 18: P3
        tally(train_cli(torch, tmp, "ssg", npoints=P3_NPOINTS, batch_size=P3_BATCH))
        tally(serve(torch, tmp, "ssg", npoints=P3_NPOINTS, batch_size=P3_BATCH))
    lap(start, "the serve and train runs of phases 9-13, 16 and 18")
    for model_kind in KINDS:
        train_step_card_vs_cpu(torch, model_kind)
        train_step_repeat_and_time(torch, model_kind)
    with switches(**MXU_CONFIG):
        train_step_card_vs_cpu(torch, "ssg", "mxu")
        train_step_repeat_and_time(torch, "ssg", "mxu")
    time_configs(torch)
    lap(start, "the steps of phases 11-12")
    tally({"launches": bench_gather(torch)})
    tally({"launches": bench_fused(torch)})
    for model_kind in KINDS:  # phase 17
        wholescene_card_vs_cpu(torch, model_kind)
        wholescene_time(model_kind)
    train_step_card_vs_cpu(torch, "ssg", npoints=P3_NPOINTS)  # phase 18
    train_step_repeat_and_time(torch, "ssg", batch_size=P3_BATCH, npoints=P3_NPOINTS)
    lap(start, "phases 14-18")
    tally({"launches": bench(torch)})  # phase 19
    lap(start, "phase 19")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 20
        tally(train_cli(torch, pathlib.Path(tmp), "ssg", trace=True))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 21
        for model_kind in KINDS:
            tally(eval_cli(torch, pathlib.Path(tmp), model_kind))
    lap(start, "phases 20-21")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 22
        run = train_cli(torch, pathlib.Path(tmp), "ssg", device_store=True)
        check_store_launches(run["launches"], host_train["ssg"]["launches"], 3, "--device_store")
        tally(run)
    tally(resident_vs_host(torch))
    check_store_gather(torch, tallies["gather"])
    print("kernel gather over the STORE shape: " + ", ".join(
        f"{k} {v:.4f}" for k, v in tallies["gather"].paths["store"].items() if v is not None), flush=True)
    lap(start, "phase 22")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 23: bfloat16
        tmp = pathlib.Path(tmp)
        for model_kind in KINDS:
            tally(serve(torch, tmp, model_kind, bf16=True))
            run = train_cli(torch, tmp, model_kind, bf16=True)
            tally(run)
            tally(eval_run(torch, run["run_dir"], model_kind))
    for model_kind in KINDS:
        train_step_card_vs_cpu_bf16(torch, model_kind)
        train_step_repeat_and_time(torch, model_kind, dtype=torch.bfloat16)
    lap(start, "phase 23")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, switches(**MXU_CONFIG):  # phase 24
        tmp = pathlib.Path(tmp)
        tally(serve(torch, tmp, "ssg", "mxu", bf16=True))
        run = train_cli(torch, tmp, "ssg", "mxu", bf16=True)
        tally(run)
        tally(eval_run(torch, run["run_dir"], "ssg", "mxu"))
        tally(serve_forward_bf16(torch, tmp, "msg"))
        lap(start, "phase 24's runs")
        for model_kind in KINDS:
            train_step_card_vs_cpu_bf16(torch, model_kind, "mxu")
        train_step_repeat_and_time(torch, "ssg", "mxu", dtype=torch.bfloat16)
    time_configs_bf16(torch)
    lap(start, "phase 24")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 25
        for run in serve_artifacts(torch, pathlib.Path(tmp)):
            tally(run)
    lap(start, "phase 25")
    tally(multiview(torch))  # phase 26
    lap(start, "phase 26")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 27
        tally(data_parallel(torch, pathlib.Path(tmp)))
    lap(start, "phase 27")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 28
        tally(fused_steps(torch, pathlib.Path(tmp)))
    lap(start, "phase 28")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 29
        tally(shape_families(torch, pathlib.Path(tmp), tallies))
    lap(start, "phase 29")
    tally(votenet(torch, tallies))
    lap(start, "phase 30")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:  # phase 31
        tally(tensor_parallel(torch, pathlib.Path(tmp)))
    lap(start, "phase 31")
    tally(op_switches(torch, tallies))  # phase 32
    lap(start, "phase 32")

    print(f"bfloat16 launches on the main path (phases 23 and 24's runs): {bf16_launches}", flush=True)
    rows = [t.row(launches[name]) for name, t in tallies.items()]
    for row in rows:
        if row["name"] in bf16_launches:
            row["bf16_launches"] = bf16_launches[row["name"]]
    rows += [t.row(bf16_launches[name]) for name, t in bf16_tallies.items()]
    print(json.dumps({"kernels": rows}))
    print(bench_torch.card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
