"""The general traffic generator. A mix file (mixes/<name>.json) holds only
parameters, read by the generator of its driver's traffic, and every draw
comes from the run's seed, so the same seed gives the same traffic.

- train_pool (the "train" driver): `rooms` synthetic rooms of
  `room_points` points and side `room_side_m`; `draws` rounds of one chunk
  a room (the reference's chunk draw, `chunk_retries`, resampled to
  `npoints`), each round's chunks shuffled and cut into batches of `batch`
  (drop_last) and augmented as they are assembled; the batches in groups
  of `group_steps`. The class weights come from the labels of the pool.
  Every seed gives the same sizes. The learning rate's staircase counts
  epochs of `scenes_per_epoch` scenes (ScanNet's train split), as the CLI
  does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pn2bench import scenes as S

_STREAMS = {"rooms": 0, "chunks": 1, "augment": 2, "order": 3}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([seed, _STREAMS[stream]])


@dataclasses.dataclass
class TrainPool:
    groups: list[list[dict[str, np.ndarray]]]  # groups of K batches
    order: np.ndarray  # the seeded order in which the window cycles the groups


def train_pool(mix: dict, seed: int, num_classes: int) -> TrainPool:
    g_rooms, g_chunks, g_aug = rng(seed, "rooms"), rng(seed, "chunks"), rng(seed, "augment")
    rooms = [S.ChunkSampler(S.fast_scene(g_rooms, mix["room_points"], mix["room_side_m"]))
             for _ in range(mix["rooms"])]
    b, n = mix["batch"], mix["npoints"]
    epochs = []
    for _ in range(mix["draws"]):
        chunks = [room.draw(g_chunks, n, mix["chunk_retries"]) for room in rooms]
        order = g_aug.permutation(len(chunks))
        epochs.append([[chunks[i] for i in order[s:s + b]] for s in range(0, len(order) - b + 1, b)])
    labels = np.concatenate([c[:, 10] for ep in epochs for batch in ep for c in batch])
    weights = S.label_weights(labels.astype(np.int64), num_classes)
    batches = []
    for ep in epochs:
        for batch in ep:
            feats, labs = [], []
            for chunk in batch:
                f = S.features(chunk)
                f[:, :3] = S.augment_coords(f[:, :3], g_aug)
                feats.append(f)
                labs.append(chunk[:, 10].astype(np.int32))
            labs = np.stack(labs)
            batches.append({"points": np.stack(feats), "labels": labs, "weights": weights[labs],
                            "row_mask": np.ones(b, np.float32)})
    k = mix["group_steps"]
    groups = [batches[i:i + k] for i in range(0, len(batches) - k + 1, k)]
    return TrainPool(groups, rng(seed, "order").permutation(len(groups)))

