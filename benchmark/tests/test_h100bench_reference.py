"""The plain reference (reference/pointnet2.py) against the program at a
small size on the CPU, where the program runs its kernels' plain versions:
the eval forward, and two train steps (loss, Adam's moments, the change of
every leaf), each held to rounding."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import BENCH

B, N = 2, 1024


def _setup(kind: str, seed: int):
    from pn2bench import port
    from pn2bench.builders import pointnet2_seg

    cfg = json.loads((BENCH / "configs" / f"{kind}.json").read_text())["model"]
    model = pointnet2_seg.build(cfg, torch.device("cpu"))
    params = port.make_params(model, seed)
    port.load_params(model, params)
    return cfg, model, params


def _batch(seed: int, classes: int = 20) -> dict:
    g = np.random.default_rng(seed)
    pts = np.concatenate([g.uniform(0, 1.5, (B, N, 3)), g.uniform(0, 1, (B, N, 6))], -1).astype(np.float32)
    labels = g.integers(0, classes, (B, N)).astype(np.int32)
    weights = g.uniform(0.5, 2.0, classes).astype(np.float32)[labels]
    return {"points": torch.from_numpy(pts), "labels": torch.from_numpy(labels),
            "weights": torch.from_numpy(weights), "row_mask": torch.ones(B)}


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_eval_forward_matches_the_program(kind):
    from reference import pointnet2 as ref

    cfg, model, params = _setup(kind, 2**31 + 17)
    x = _batch(1)["points"]
    with torch.no_grad():
        got = model.eval()(x)
    want = ref.forward(cfg, params, x, train=False)
    assert got.shape == want.shape == (B, N, 20)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_train_steps_match_the_program(kind):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pn2bench import check, port
    from reference import pointnet2 as ref

    cfg, model, params = _setup(kind, 5)
    state, _ = port.fused_train(model, lr=1e-3, decay_step_epochs=1, decay_factor=0.7, steps_per_epoch=1,
                                weight_decay=0.0, dropout_seed=9, num_classes=20)
    batches = [_batch(2), _batch(3)]
    losses = [float(ts.train_step(state, b, num_classes=20)["loss"]) for b in batches]
    prog = {"losses": losses, "params": dict(model.named_parameters()), "moments": port.adam_moments(state)}
    trainer = ref.Trainer(cfg, params, lr_at=lambda s: 1e-3 * 0.7 ** s, weight_decay=0.0,
                          generator=torch.Generator().manual_seed(9))
    want = {"losses": [trainer.step(b) for b in batches], "params": trainer.p, "moments": trainer.m}
    detail: dict = {}
    got = check.train_numbers(prog, want, params, detail)
    assert max(detail["loss_gaps"]) <= 1e-6 and detail["worst_moment_gap"] <= 1e-4, detail
    assert got["worst_update_gap"] <= 1e-4 and got["update_gap"] <= 1e-4, got
