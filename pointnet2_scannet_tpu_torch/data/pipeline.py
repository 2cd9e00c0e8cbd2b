"""Batching and host-to-device prefetch.

BatchLoader is the JAX package's data/pipeline.py as it is: fixed-shape
(B, npoints, 3 + C) numpy batches in fixed scene order (or shuffled), with
drop_last for training and pad_last plus a `row_mask` for validation.

prefetch_to_device overlaps host batch assembly and the copy to the card
with the step that runs on it: a background thread pins each host batch and
copies it on a side CUDA stream, recording an event; the consumer makes its
current stream wait on that event before it touches the batch. On the CPU it
is a plain pass-through that wraps the arrays as tensors.

prefetch_groups feeds the fused steps (parallel/step.make_fused_train_step):
a background thread stacks each K host batches into one HostGroup, a single
(pinned, on a card) buffer that holds every array of the group at its
GroupLayout offsets, and hands the epoch's leftover batches over one at a
time. The consumer copies a group into the CUDA graph's input slots, which
share the layout, with one non_blocking copy on its own stream, so the copy
is ordered before the graph's launch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections.abc import Iterator

import numpy as np
import torch

from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset

PREFETCH = 2  # batches copied ahead of the step


class BatchLoader:
    """Assembles fixed-shape batches from a chunk dataset."""

    def __init__(
        self,
        dataset: ChunkedSceneDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = False,
        seed: int = 0,
    ):
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last are mutually exclusive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        full, rem = divmod(len(self.dataset), self.batch_size)
        if self.drop_last or rem == 0:
            return full
        return full + 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        """Batches of "points", "labels", "weights" and "row_mask" (B,)
        float32, 1 for a real row and 0 for a pad_last padding row."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            if len(idxs) < self.batch_size and self.drop_last:
                return
            feats, labels, weights = (
                list(x) for x in zip(*(self.dataset.get_item(int(i)) for i in idxs))
            )
            real = len(idxs)
            if real < self.batch_size:
                if not self.pad_last:
                    yield {
                        "points": np.stack(feats),
                        "labels": np.stack(labels),
                        "weights": np.stack(weights),
                        "row_mask": np.ones(real, np.float32),
                    }
                    return
                for _ in range(self.batch_size - real):
                    feats.append(np.zeros_like(feats[0]))
                    labels.append(np.zeros_like(labels[0]))
                    weights.append(np.zeros_like(weights[0]))
            row_mask = np.zeros(self.batch_size, np.float32)
            row_mask[:real] = 1.0
            yield {
                "points": np.stack(feats),
                "labels": np.stack(labels),
                "weights": np.stack(weights),
                "row_mask": row_mask,
            }


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device` (blocking copies)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def prefetch_to_device(
    iterator,
    *,
    device: torch.device | str,
    keep_host: bool = False,
) -> Iterator:
    """Yield each numpy batch of `iterator` as tensors on `device`, or as
    (host batch, device batch) pairs with keep_host.

    On a CUDA device a background thread keeps up to PREFETCH batches copied
    ahead; the copies run on a side stream from pinned memory, and each
    batch is handed over with an event that the consumer's current stream
    waits on, so no host synchronisation sits between steps.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for item in iterator:
            placed = to_device(item, device)
            yield (item, placed) if keep_host else placed
        return

    def copies(copy_stream: torch.cuda.Stream):
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            for item in iterator:
                placed = {
                    k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                    for k, v in item.items()
                }
                ready = torch.cuda.Event()
                ready.record(copy_stream)
                yield item, placed, ready

    for item, placed, ready in _background(copies(torch.cuda.Stream(device))):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for t in placed.values():
            t.record_stream(stream)  # allocated on the side stream, used here
        yield (item, placed) if keep_host else placed

_ALIGN = 256  # bytes: every array of a group starts on this boundary


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Where each array of a K-stacked group lies in one flat byte buffer:
    (name, shape with the leading K, torch dtype, byte offset) per array,
    in the order of the batch's keys."""

    fields: tuple[tuple[str, tuple[int, ...], torch.dtype, int], ...]
    nbytes: int

    @classmethod
    def of(cls, shapes: dict[str, tuple[tuple[int, ...], torch.dtype]]) -> "GroupLayout":
        fields, offset = [], 0
        for name, (shape, dtype) in shapes.items():
            fields.append((name, tuple(shape), dtype, offset))
            size = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            offset += -(-size // _ALIGN) * _ALIGN
        return cls(tuple(fields), offset)

    @property
    def k(self) -> int:
        return self.fields[0][1][0]

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Each array as a view of the flat uint8 buffer."""
        out = {}
        for name, shape, dtype, offset in self.fields:
            size = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            out[name] = flat[offset : offset + size].view(dtype).view(shape)
        return out


class HostGroup:
    """K host batches stacked into one host buffer (pinned with pin=True):
    layout, buffer (flat uint8), arrays (name -> (K, ...) tensor views of
    buffer). Every batch must have the same keys, shapes and dtypes."""

    def __init__(self, batches: list[dict[str, np.ndarray]], *, pin: bool = False):
        first = batches[0]
        self.layout = GroupLayout.of({
            name: ((len(batches),) + a.shape, torch.from_numpy(np.ascontiguousarray(a[:0])).dtype)
            for name, a in first.items()})
        self.buffer = torch.empty(self.layout.nbytes, dtype=torch.uint8, pin_memory=pin)
        self.arrays = self.layout.views(self.buffer)
        for name, view in self.arrays.items():
            np.stack([b[name] for b in batches], out=view.numpy())

    @property
    def k(self) -> int:
        return self.layout.k

    def to(self, device: torch.device | str) -> dict[str, torch.Tensor]:
        """The group's arrays on device, moved by one copy of the buffer
        (non_blocking from pinned memory, on the current stream)."""
        return self.layout.views(self.buffer.to(device, non_blocking=True))


def prefetch_groups(iterator, k: int, *, device: torch.device | str) -> Iterator:
    """Yield each k batches of `iterator` as one HostGroup, then the leftover
    (fewer than k) batches as host batches, one at a time (the JAX
    package's Solver._fused_group_stream). On a CUDA device a background
    thread stacks the groups into pinned buffers, PREFETCH of them ahead;
    on the CPU they are stacked in line."""
    device = torch.device(device)

    def groups():
        buf = []
        for batch in iterator:
            buf.append(batch)
            if len(buf) == k:
                yield HostGroup(buf, pin=device.type == "cuda")
                buf = []
        yield from buf

    if device.type != "cuda":
        yield from groups()
        return
    yield from _background(groups())


def _background(iterator) -> Iterator:
    """The items of iterator, produced by a background thread up to PREFETCH
    ahead; an exception there is raised here."""
    q: queue.Queue = queue.Queue(maxsize=PREFETCH)
    done = object()
    stop = threading.Event()
    errors: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            errors.append(e)
        finally:
            if hasattr(iterator, "close"):  # a generator's cleanup runs on this thread
                iterator.close()
            put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is done:
                if errors:
                    raise errors[0]
                return
            yield got
    finally:
        stop.set()
        thread.join(timeout=10)
