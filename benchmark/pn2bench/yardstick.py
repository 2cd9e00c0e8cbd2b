"""The yardstick: the card's published peaks, the model's analytic matmul
FLOPs, the least time of a piece of work, and the classes of kernel names.

Copies: fwd_matmul_flops is bench_torch.fwd_matmul_flops (itself bench.py's),
here over a configuration's "model" entry; the peaks are bench_torch's
F32_PEAK and chip_smoke.py's HBM_BYTES_PER_S / F32_OPS_PER_S; the kernel
classes are scripts/profile_torch.py's _CLASSES, tried in order.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: float32 outside the tensor cores
# (TF32 is off in every configuration here), and HBM3's rate
F32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_CLASSES = (
    ("hand-written", ("p2_", "fps_kernel", "fps_cluster_kernel", "ball_query", "gather_kernel",
                      "three_nn_kernel", "segment_sum_kernel", "block_kernel", "tile_count_kernel",
                      "tile_prefix_kernel", "row_scan_kernel", "place_kernel", "accumulate_kernel",
                      "fixed_kernel", "general_kernel")),
    ("GEMM", ("gemm", "sgemm", "cutlass", "cublas", "xmma", "sm90_")),
    ("reduction", ("reduce", "Reduce", "scan", "Scan", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
)


def kernel_class(name: str) -> str:
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def fwd_matmul_flops(model: dict, B: int, N: int) -> float:
    """Forward matmul FLOPs (pointwise MLPs and head) of one batch of B
    columns of N points."""
    pts = [N] + list(model["npoints"])
    f = 0.0
    cin_feats = model["input_channels"]
    for lvl in range(len(model["npoints"])):
        M = model["npoints"][lvl]
        for s, widths in enumerate(model["sa_mlps"][lvl]):
            K = model["nsamples"][lvl][s]
            cin = cin_feats + (3 if model["use_xyz"] else 0)
            for w in widths:
                f += 2.0 * B * M * K * cin * w
                cin = w
        cin_feats = sum(w[-1] for w in model["sa_mlps"][lvl])
    chans = [model["input_channels"]] + [sum(m[-1] for m in level) for level in model["sa_mlps"]]
    cur = chans[-1]
    for lvl in reversed(range(len(model["fp_mlps"]))):
        cin = cur + chans[lvl]
        for w in model["fp_mlps"][lvl]:
            f += 2.0 * B * pts[lvl] * cin * w
            cin = w
        cur = cin
    cin = cur
    for w in model["cls_fc"]:
        f += 2.0 * B * N * cin * w
        cin = w
    f += 2.0 * B * N * cin * model["num_classes"]
    return f


def least_seconds(device: str, nbytes: float, nops: float) -> float | None:
    """The least time the card could take for the work: bytes over the
    memory rate or float32 operations over their peak, the larger; None
    for a card not in the table."""
    if device not in F32_FLOPS:
        return None
    return max(nbytes / HBM_BYTES_PER_S[device], nops / F32_FLOPS[device])


def sa_levels(model: dict, N: int) -> list[dict]:
    """Each set abstraction's shapes: source points n, centroids m, source
    feature channels c, and per scale (nsample k, first MLP width w0)."""
    out, n, c = [], N, model["input_channels"]
    for lvl, m in enumerate(model["npoints"]):
        scales = [(k, widths[0]) for k, widths in zip(model["nsamples"][lvl], model["sa_mlps"][lvl])]
        out.append({"n": n, "m": m, "c": c, "scales": scales})
        n, c = m, sum(w[-1] for w in model["sa_mlps"][lvl])
    return out


def fp_levels(model: dict, N: int) -> list[dict]:
    """Each feature propagation's shapes, deepest first: unknown points n,
    known points m, known feature channels c."""
    pts = [N] + list(model["npoints"])
    c = sum(w[-1] for w in model["sa_mlps"][-1])
    out = []
    for lvl in reversed(range(len(model["fp_mlps"]))):
        out.append({"n": pts[lvl], "m": pts[lvl + 1], "c": c})
        c = model["fp_mlps"][lvl][-1]
    return out
