"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version and a launch counter.

Every kernel module carries `NAME`, `SOURCE` (its .cu file), `REPLACES` (the
TPU kernel it ports, file:line), `launches` (incremented once per kernel
launch and nowhere else), `<op>_plain` and `<op>_cuda`; the gathers (d, e,
g) and the scatter-adds (h, f) also count their bfloat16 launches
(`bf16_launches`). The
public ops in ops/ pick between the two by the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises.

The wrappers are safe to capture in a CUDA graph (the fused train steps,
parallel/step.py): each launches on PyTorch's current stream
(build.stream_of), allocates only through the caching allocator
(torch.empty / torch.zeros, from the graph's pool under a capture), takes
its launch shape from the shapes alone (plan()), and neither synchronises
nor copies from host memory. A counter counts where Python calls the
wrapper: a capture counts the launches it records, a replay none.
"""

from __future__ import annotations

from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel,
    ball_query_multi_kernel,
    fps_kernel,
    fused_gather_mm_kernel,
    gather_kernel,
    gather_smem_kernel,
    gather_split_kernel,
    scatter_kernel,
    scatter_smem_kernel,
    three_nn_kernel,
    three_nn_q_kernel,
)

KERNELS = (
    fps_kernel, ball_query_kernel, gather_kernel, three_nn_kernel, scatter_kernel,
    ball_query_multi_kernel, gather_smem_kernel, scatter_smem_kernel, three_nn_q_kernel,
    gather_split_kernel, fused_gather_mm_kernel,
)

# the kernels that take bfloat16 rows, each counting those launches apart
BF16_KERNELS = (gather_kernel, scatter_kernel, gather_smem_kernel, scatter_smem_kernel, gather_split_kernel)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in BF16_KERNELS:
        k.bf16_launches = 0
    for variant in fps_kernel.variant_launches:
        fps_kernel.variant_launches[variant] = 0


def launch_counts() -> dict[str, int]:
    return {k.NAME: k.launches for k in KERNELS}


def bf16_launch_counts() -> dict[str, int]:
    """The gathers' and the scatter-adds' launches on bfloat16 rows."""
    return {k.NAME: k.bf16_launches for k in BF16_KERNELS}


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices have
    neither a kernel nor a plain version here."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
