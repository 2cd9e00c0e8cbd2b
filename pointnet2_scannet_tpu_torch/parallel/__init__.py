"""Data parallelism across processes: one process per device over
torch.distributed (the JAX package's parallel/, whose one process drives a
mesh of devices). distributed.py joins the ranks and holds the collectives
(ProcessContext, the autograd-aware all-reduce of the BatchNorm statistics,
the gradient all-reduce); step.py builds the data-parallel train, eval and
accumulation steps."""

from pointnet2_scannet_tpu_torch.parallel.distributed import (
    ProcessContext,
    all_reduce_grads,
    all_reduce_sum,
    check_ranks_fit,
    dropout_seed,
    initialize_distributed,
    spawn,
    strided_shard,
)

__all__ = [
    "ProcessContext",
    "all_reduce_grads",
    "all_reduce_sum",
    "check_ranks_fit",
    "dropout_seed",
    "initialize_distributed",
    "spawn",
    "strided_shard",
]
