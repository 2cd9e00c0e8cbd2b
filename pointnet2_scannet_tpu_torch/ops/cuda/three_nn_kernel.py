"""Three nearest neighbours: the CUDA kernel (csrc/three_nn.cu) and its plain
PyTorch version.

Replaces pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py
(three_nn_pallas_t). On the card the op is bound by instruction issue, its
n x m unfused distance evaluations. Each thread holds 1, 2 or 4 unknown
points with a running top-3 each in registers, the known points of the
batch row sit in shared memory as float4 (one 16-byte broadcast load feeds
every query of the thread), and insertion in index order with strict <
reproduces the lowest-index tie-break of the TPU kernel's knock-out passes.
plan() sizes the launch so that the deep levels' few queries still spread
over the card; see csrc/three_nn.cu.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_scannet_tpu_torch.ops.common import pairwise_sqdist
from pointnet2_scannet_tpu_torch.ops.cuda import build

NAME = "three_nn"
SOURCE = "pointnet2_scannet_tpu_torch/csrc/three_nn.cu"
REPLACES = "pointnet2_scannet_tpu/ops/pallas/three_nn_kernel.py:94"

PER_THREAD = (4, 2, 1)  # unknown points a thread holds, most first
THREADS = (256, 128, 64)  # threads a block, most first
# warps a multiprocessor below which a thread holds fewer unknown points
MIN_WARPS_PER_SM = 8

launches = 0


class Plan(NamedTuple):
    per_thread: int  # unknown points a thread holds: 4, 2 or 1
    threads: int  # threads a block: 256, 128 or 64
    blocks: int  # blocks a batch row


def _plan(n: int, per_thread: int, threads: int) -> Plan:
    return Plan(per_thread, threads, -(-n // (per_thread * threads)))


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, m: int, sms: int) -> Plan:
    """The launch for (b, n) unknown and (b, m) known points on a card of
    sms multiprocessors: the most unknown points a thread (4, 2, 1) that
    still leaves MIN_WARPS_PER_SM warps a multiprocessor, then the most
    threads a block (256, 128, 64) that still leaves a block a
    multiprocessor. m does not change the choice: every known point is
    scanned alike, kTile at a time."""
    per = next((p for p in PER_THREAD if b * -(-n // p) >= MIN_WARPS_PER_SM * 32 * sms), 1)
    threads = next((t for t in THREADS if b * -(-n // (per * t)) >= sms), THREADS[-1])
    return _plan(n, per, threads)


def candidate_plans(b: int, n: int, m: int) -> list:
    """Every launch shape the kernel takes, for profiling."""
    return [_plan(n, p, t) for p in PER_THREAD for t in THREADS]


def three_nn_plain(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) -> (dist2 (B, n, 3) ascending, idx (B, n, 3) int32).

    Three rounds of min, first index attaining it, knock-out — the TPU
    kernel's passes, so ties go to the lowest index.
    """
    d = pairwise_sqdist(unknown, known)  # (B, n, m)
    m = d.shape[-1]
    iota = torch.arange(m, dtype=torch.int32, device=d.device)
    sentinel = torch.tensor(m, dtype=torch.int32, device=d.device)
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    dists, idxs = [], []
    for k in range(3):
        dmin = d.amin(dim=-1, keepdim=True)
        sel = torch.where(d == dmin, iota, sentinel).amin(dim=-1, keepdim=True)
        dists.append(dmin)
        idxs.append(sel)
        if k < 2:
            d = torch.where(iota == sel, inf, d)
    return torch.cat(dists, dim=-1), torch.cat(idxs, dim=-1)


def launch(unknown: torch.Tensor, known: torch.Tensor, dist2: torch.Tensor, idx: torch.Tensor,
           p: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """three_nn.cu with plan p into dist2 and idx (B, n, 3) on checked
    tensors. Counts no launch: three_nn_cuda and
    three_nn_q_kernel.three_nn_q_cuda count theirs."""
    B, n, _ = unknown.shape
    err = build.library().p2_three_nn(
        unknown.data_ptr(), known.data_ptr(), B, n, known.shape[1], p.per_thread, p.threads,
        dist2.data_ptr(), idx.data_ptr(), unknown.get_device(), build.stream_of(unknown))
    build.check(err, NAME)
    return dist2, idx


def run(
    unknown: torch.Tensor, known: torch.Tensor, kernel: str = NAME
) -> tuple[torch.Tensor, torch.Tensor]:
    """Check (B, n, 3) x (B, m, 3) float32 on the card, m >= 3, allocate
    dist2 and idx and launch three_nn.cu with plan() unless B * n == 0;
    the batch-limit error names `kernel`. Counts no launch."""
    build.require(unknown, "unknown", (torch.float32,), 3, 3)
    build.require(known, "known", (torch.float32,), 3, 3)
    B, n, _ = unknown.shape
    m = known.shape[1]
    if known.shape[0] != B or known.get_device() != unknown.get_device():
        raise ValueError("unknown and known must share batch size and device")
    if m < 3:
        raise ValueError(f"three_nn needs at least 3 known points, got {m}")
    build.check_batch(B, kernel)
    dist2 = torch.empty((B, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=unknown.device)
    if B * n == 0:
        return dist2, idx
    return launch(unknown, known, dist2, idx, plan(B, n, m, build.sm_count(unknown)))


def three_nn_cuda(
    unknown: torch.Tensor, known: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) float32 on the card, m >= 3 -> (dist2, idx);
    launches three_nn.cu."""
    global launches
    out = run(unknown, known)
    if out[0].numel():
        launches += 1
    return out
