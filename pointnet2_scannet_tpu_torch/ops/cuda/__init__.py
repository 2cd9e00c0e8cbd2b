"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version and a launch counter.

Every kernel module carries `NAME`, `SOURCE` (its .cu file), `REPLACES` (the
TPU kernel it ports, file:line), `launches` (incremented once per kernel
launch and nowhere else), `<op>_plain` and `<op>_cuda`. The public ops in
ops/ pick between the two by the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel,
    ball_query_multi_kernel,
    fps_kernel,
    gather_kernel,
    scatter_kernel,
    three_nn_kernel,
)

KERNELS = (
    fps_kernel, ball_query_kernel, gather_kernel, three_nn_kernel, scatter_kernel,
    ball_query_multi_kernel,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.NAME: k.launches for k in KERNELS}


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices have
    neither a kernel nor a plain version here."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
