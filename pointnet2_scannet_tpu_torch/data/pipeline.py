"""Batching and host-to-device prefetch.

BatchLoader is the JAX package's data/pipeline.py as it is: fixed-shape
(B, npoints, 3 + C) numpy batches in fixed scene order (or shuffled), with
drop_last for training and pad_last plus a `row_mask` for validation.

prefetch_to_device overlaps host batch assembly and the copy to the card
with the step that runs on it: a background thread pins each host batch and
copies it on a side CUDA stream, recording an event; the consumer makes its
current stream wait on that event before it touches the batch. On the CPU it
is a plain pass-through that wraps the arrays as tensors.
"""

from __future__ import annotations

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

    def producer(copy_stream: torch.cuda.Stream):
        try:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                for item in iterator:
                    placed = {
                        k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                            device, non_blocking=True
                        )
                        for k, v in item.items()
                    }
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                    if not put((item, placed, ready)):
                        return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            errors.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, args=(torch.cuda.Stream(device),), daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is done:
                if errors:
                    raise errors[0]
                return
            item, placed, ready = got
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for t in placed.values():
                t.record_stream(stream)  # allocated on the side stream, used here
            yield (item, placed) if keep_host else placed
    finally:
        stop.set()
        thread.join(timeout=10)
