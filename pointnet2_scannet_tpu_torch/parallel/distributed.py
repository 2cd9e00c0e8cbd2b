"""Multi-process data parallelism over torch.distributed: the JAX package's
parallel/distributed.py (ProcessContext :65, strided_shard :47,
initialize_distributed :293).

The JAX package runs one process per host, which drives a mesh of that
host's devices. The port runs one process (a rank) per device, PyTorch's
idiom: `--num_devices N` on one host spawns N ranks, one card each, joined
by NCCL, or N CPU ranks joined by gloo with `--device cpu`; the `--dist_*`
flags join ranks across hosts. What the JAX package spreads over a mesh the
port spreads over ranks:

  1. each rank trains on its own rows of the global batch: the data layer
     gives every rank a disjoint scene shard (strided_shard), or every rank
     walks the same whole scenes and takes its rows of each micro-batch
     (ProcessContext.place_from_global);
  2. inside the step, the BatchNorm statistics are summed across ranks by
     an all-reduce whose backward sums the cotangents (all_reduce_sum), and
     the gradients by one all-reduce of the flat gradient after the backward
     (all_reduce_grads), so that every rank applies the single-process
     gradient of the global batch;
  3. host bookkeeping: float64 metric sums and label counts, ragged
     per-scene results and uniformity checks travel over a gloo group
     (NCCL takes no host tensors), and every write of a log, a checkpoint
     or best.txt is the coordinator's (rank 0).

Tensor parallelism (parallel/mesh.py, the JAX package's dp x tp mesh) lays
the ranks out on a 2-D grid, dp x tp. The ranks of a dp index split every
Linear's output channels among them (a column-parallel Linear); two
autograd collectives over their tp group carry the activations:
column_parallel_input (the identity, whose backward sums the input's
cotangent over the tp ranks) and all_gather_channels (the channel shards
concatenated in tp order, whose backward takes this rank's slice). Items 1
and 2 then run over the dp group alone, and the host helpers of item 3 that
concern the data (shard_list, place_from_global, all_rows, the sums) over
the ranks of one tp index: the tp ranks of a dp index hold the same rows.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def strided_shard(items: Sequence, process_id: int, num_processes: int, *, equalize: bool = True) -> list:
    """Rank p's items: items[p::num_processes]. equalize truncates every
    shard to len(items) // num_processes (training: unequal step counts
    would leave one rank waiting in a collective); evaluation passes False
    to cover every item."""
    if num_processes <= 1:
        return list(items)
    out = list(items)[process_id::num_processes]
    if equalize:
        out = out[: len(items) // num_processes]
    return out


def dropout_seed(seed: int, rank: int) -> int:
    """The seed of rank's Dropout generator: seed itself on rank 0 (so one
    rank draws what a single process draws), another stream on every other
    rank (the counterpart of the JAX step's fold_in of the device index)."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B97F4A7C15) % 2**63


def check_ranks_fit(ranks: int, cards: int) -> None:
    """Raise unless every rank on a host can have a card of its own."""
    if ranks > cards:
        raise ValueError(
            f"{ranks} ranks on this host but only {cards} CUDA device(s): each rank takes a card "
            "of its own (no two ranks share one, and none falls back to the CPU)"
        )


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group`; the backward sums the cotangents over
    the ranks too, so each rank's inputs receive the gradient of the global
    loss through every rank's use of the sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of group, differentiable (flax's
    BatchNorm(axis_name=...) psum, whose transpose sums the cotangents)."""
    return _AllReduceSum.apply(x, group)


class _ColumnParallelInput(torch.autograd.Function):
    """The input of a column-parallel Linear: the identity forward; the
    backward sums the cotangent over the ranks of the tp group, since each
    rank's is only its output shard's share of it (Megatron-LM's f). A
    bfloat16 cotangent is summed in float32 and rounded once."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = grad.to(torch.promote_types(grad.dtype, torch.float32), memory_format=torch.contiguous_format,
                        copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


def column_parallel_input(x: torch.Tensor, group) -> torch.Tensor:
    """x as the input of a Linear whose output channels are split over the
    ranks of group (the tp group): the identity, differentiable with a
    backward that sums x's cotangent over the ranks."""
    return _ColumnParallelInput.apply(x, group)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x, concatenated on the last axis in group-rank order
    (not differentiable: all_gather_channels is).
    NCCL gathers on the card; gloo takes no CUDA tensor in all_gather on
    every PyTorch version, so under gloo the shards travel as host copies
    (no copy at all for a CPU tensor) and the result is copied back."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return torch.cat(out.unbind(0), dim=-1)
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim=-1).to(x.device)


class _AllGatherChannels(torch.autograd.Function):
    """The channel shards of the tp ranks concatenated in tp order; the
    backward takes this rank's slice of the cotangent (Megatron-LM's g: the
    ranks downstream compute the same function, so each holds the whole
    cotangent already)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.rank, ctx.c = dist.get_rank(group), x.shape[-1]
        return all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[..., ctx.rank * ctx.c : (ctx.rank + 1) * ctx.c].contiguous(), None


def all_gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """(..., C / tp) channel shards -> (..., C), every rank's shard in tp
    order (group-rank order), differentiable."""
    return _AllGatherChannels.apply(x, group)


def all_reduce_grads(params, group) -> None:
    """Sum every parameter's .grad over the ranks of group in one all-reduce
    of their concatenation (the ranks run the same model, so the same
    parameters have one)."""
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad = flat[offset : offset + p.numel()].view_as(p)
        offset += p.numel()


@dataclasses.dataclass(frozen=True)
class ProcessContext:
    """This rank within a data-parallel run. One process without a process
    group is the ordinary single-device case, where every helper is a local
    no-op.

    group: the process group of the device collectives over every rank
    (NCCL between cards, gloo on the CPU); None without one. host_group: a
    gloo group over the same ranks for host numpy vectors (float64 stays
    float64). local_rank: this rank's index among the ranks of its host.
    grid: the dp x tp layout of a tensor-parallel run (parallel/mesh.Grid:
    the coordinates and the groups), None for data parallelism alone, where
    the dp group is group and tp is 1."""

    process_id: int = 0
    num_processes: int = 1
    group: Any = None
    host_group: Any = None
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    grid: Any = None

    @classmethod
    def single(cls, device: torch.device | str = "cpu") -> "ProcessContext":
        return cls(device=torch.device(device))

    # ------------------------------------------------------------ the 2-D grid

    @property
    def tp(self) -> int:
        return self.grid.tp if self.grid is not None else 1

    @property
    def dp(self) -> int:
        """The data-parallel ranks: every rank without a grid."""
        return self.grid.dp if self.grid is not None else self.num_processes

    @property
    def dp_index(self) -> int:
        return self.grid.dp_index if self.grid is not None else self.process_id

    @property
    def tp_index(self) -> int:
        return self.grid.tp_index if self.grid is not None else 0

    @property
    def dp_group(self):
        """The device group of the ranks that hold other rows of the global
        batch (the BatchNorm statistics, gradients, loss and confusion sum
        over it); None where there is one such rank."""
        return self.grid.dp_group if self.grid is not None else self.group

    @property
    def tp_group(self):
        """The device group of the ranks that split this rank's channels;
        None without tensor parallelism."""
        return self.grid.tp_group if self.grid is not None else None

    @property
    def _data_host_group(self):
        return self.grid.dp_host_group if self.grid is not None else self.host_group

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def say(self, *args, **kwargs) -> None:
        """print() on the coordinator only (N ranks would print N copies)."""
        if self.is_coordinator:
            print(*args, **kwargs)

    # ------------------------------------------------------------- data layer

    def shard_list(self, items: Sequence, *, equalize: bool = True) -> list:
        """This rank's strided shard (strided_shard) over the dp ranks (the
        tp ranks of a dp index take the same)."""
        return strided_shard(items, self.dp_index, self.dp, equalize=equalize)

    def place_from_global(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """This rank's rows of a batch that every rank holds whole (a
        whole-scene micro-batch): rows [p * B / P, (p + 1) * B / P) of the P
        dp ranks, p its dp index."""
        if self.dp == 1:
            return batch

        def rows(x: np.ndarray) -> np.ndarray:
            n = x.shape[0]
            if n % self.dp:
                raise ValueError(f"global batch of {n} rows not divisible by {self.dp} ranks")
            local = n // self.dp
            return x[self.dp_index * local : (self.dp_index + 1) * local]

        return {k: rows(v) for k, v in batch.items()}

    # -------------------------------------------------------- output readback

    def local_rows(self, t: torch.Tensor) -> np.ndarray:
        """This rank's rows of a step output: the rank holds no other."""
        return t.cpu().numpy()

    def all_rows(self, rows: np.ndarray) -> np.ndarray:
        """Every dp rank's rows of equal-shaped blocks, in rank order, on
        every rank (one all-gather; validation cadence only)."""
        rows = np.asarray(rows)
        if self.dp == 1:
            return rows
        t = torch.from_numpy(np.ascontiguousarray(rows))
        out = [torch.empty_like(t) for _ in range(self.dp)]
        dist.all_gather(out, t, group=self._data_host_group)
        return torch.cat(out).numpy()

    # ------------------------------------------------------- host aggregation

    def sum_across_processes(self, values: np.ndarray) -> np.ndarray:
        """Element-wise sum of a small host vector over the dp ranks, in its
        own dtype (float64 label counts past 2^24 stay exact)."""
        values = np.asarray(values)
        if self.dp == 1:
            return values
        t = torch.from_numpy(np.ascontiguousarray(values)).clone()
        dist.all_reduce(t, group=self._data_host_group)
        return t.numpy()

    def allgather_ragged(self, rows: np.ndarray) -> np.ndarray:
        """The (n_p, ...) row blocks of every dp rank concatenated in rank
        order; n_p may differ between ranks (padded to the largest for the
        collective). The dtype is kept: float64 results stay float64."""
        rows = np.asarray(rows)
        if self.dp == 1:
            return rows
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(self.dp)]
        dist.all_gather(counts, torch.tensor([rows.shape[0]], dtype=torch.int64), group=self._data_host_group)
        counts = [int(c) for c in counts]
        padded = np.zeros((max(counts),) + rows.shape[1:], rows.dtype)
        padded[: rows.shape[0]] = rows
        blocks = self.all_rows(padded).reshape((self.dp, max(counts)) + rows.shape[1:])
        return np.concatenate([blocks[p, : counts[p]] for p in range(self.dp)])

    def allgather_object(self, obj) -> list:
        """A picklable object from every rank, in rank order."""
        if self.num_processes == 1:
            return [obj]
        out = [None] * self.num_processes
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def broadcast_object(self, obj):
        """The coordinator's value of a picklable object, on every rank."""
        if self.num_processes == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def assert_uniform(self, value: int, name: str) -> None:
        """Raise if a count that gates collectives (steps per epoch) differs
        between ranks: a mismatch would hang mid-epoch instead."""
        got = self.allgather_object(int(value))
        if any(v != value for v in got):
            raise ValueError(f"{name} differs across ranks: local={value}, all={got}")

    def barrier(self, name: str) -> None:
        """Wait for every rank (name says where, for a reader of a hang)."""
        if self.num_processes > 1:
            dist.barrier(group=self.host_group)


def _env_int(*names: str, default: int) -> int:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return default


def initialize_distributed(
    coordinator_address: str | None,
    num_processes: int = 1,
    process_id: int = 0,
    *,
    auto: bool = False,
    device: torch.device | str = "cuda",
    backend: str | None = None,
) -> ProcessContext:
    """Join a data-parallel run and return this rank's context.

    coordinator_address host:port (every rank passes the same; rank 0 binds
    it) with num_processes and process_id, or auto: torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; SLURM_NTASKS and
    SLURM_PROCID where RANK is unset) through env://. One process without
    auto initialises nothing.

    The backend is NCCL on a card and gloo on the CPU; a gloo group joins
    the same ranks for the host vectors. A rank takes the card of its index
    among its host's ranks, and more ranks on a host than it has cards
    raise; CPU ranks divide the host's cores among them (unless
    OMP_NUM_THREADS says otherwise). backend: an explicit backend; under
    gloo the ranks of a host may share its cards (several gloo ranks on one
    card check the collectives, not their speed). On a card, the host's
    first rank builds the CUDA kernels while the others wait (one nvcc run
    per host)."""
    device = torch.device(device)
    if auto:
        world = _env_int("WORLD_SIZE", "SLURM_NTASKS", default=1)
        rank = _env_int("RANK", "SLURM_PROCID", default=0)
        init_method = "env://"
    elif num_processes <= 1:
        return ProcessContext.single(device)
    else:
        if not coordinator_address:
            raise ValueError("distributed runs need --dist_coordinator host:port (the same address on "
                             "every rank; rank 0 binds it)")
        world, rank, init_method = num_processes, process_id, f"tcp://{coordinator_address}"
    explicit = backend is not None
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname(), group=host_group)
    local_rank, local_size = hosts[:rank].count(hosts[rank]), hosts.count(hosts[rank])
    if device.type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // local_size))
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if not (explicit and backend == "gloo"):
            check_ranks_fit(local_size, cards)
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    ctx = ProcessContext(rank, world, dist.group.WORLD, host_group, local_rank, device)
    if device.type == "cuda":
        build_once_per_host(ctx)
    return ctx


def build_once_per_host(ctx: ProcessContext) -> None:
    """Build the CUDA kernel library on the host's first rank while the
    others wait, so that N ranks start one nvcc build and not N; each rank
    loads the built library at its first launch."""
    from pointnet2_scannet_tpu_torch.ops.cuda import build

    if ctx.local_rank == 0:
        build.ensure_built()
    ctx.barrier("kernel build")


def shutdown(ctx: ProcessContext) -> None:
    """Leave the process group, after every rank got here."""
    if ctx.group is not None:
        ctx.barrier("end")
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, nprocs: int, args: tuple = (), timeout: float | None = None) -> None:
    """Run fn(rank, *args) in nprocs fresh processes (the spawn method) and
    wait for all of them. A rank that raises ends the others and raises
    here; past timeout seconds the survivors are killed and TimeoutError
    raised."""
    import torch.multiprocessing as mp

    procs = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not procs.join(timeout=None if deadline is None else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()


def dist_flags_set(args) -> bool:
    """Whether a CLI's --dist_* flags join ranks (args: --dist_*)."""
    return (args.dist_coordinator is not None or args.dist_nprocs != 1 or args.dist_pid != 0
            or args.dist_auto)


def cli_ranks(args) -> int:
    """The ranks that a CLI's --num_devices spawns on this host (1: none),
    after its refusals: --num_devices with a --dist_* flag, more ranks than
    the host has cards. args: --num_devices, --dist_*, --device."""
    n = args.num_devices or 1
    if n > 1 and dist_flags_set(args):
        raise ValueError("--num_devices cannot be combined with --dist_*: --num_devices spawns the ranks "
                         "of one host, --dist_* joins ranks started by hand or by a launcher")
    if n > 1 and torch.device(args.device).type == "cuda":
        check_ranks_fit(n, torch.cuda.device_count())
    return n


def cli_context(args) -> ProcessContext:
    """The context of a CLI process: the rank that its --dist_* flags name,
    or the one process."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    return initialize_distributed(args.dist_coordinator, args.dist_nprocs, args.dist_pid,
                                  auto=args.dist_auto, device=device)


def spawn_cli(entry: Callable, args, nprocs: int) -> None:
    """Run entry(args, ctx) on nprocs ranks of this host, spawned and joined
    over localhost (a CLI's --num_devices)."""
    spawn(_cli_rank, nprocs, (entry, args, f"127.0.0.1:{free_port()}"))


def _cli_rank(rank: int, entry: Callable, args, address: str) -> None:
    ctx = initialize_distributed(address, args.num_devices, rank, device=args.device)
    entry(args, ctx)
    shutdown(ctx)
