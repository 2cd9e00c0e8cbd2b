"""A run with the timed path broken underneath comes out not correct. The
look for a card is skipped: each test drives the rest of a run on the CPU
at a small size (harness.run_cell), with the program's step broken where it
is produced, once for each fault a one-card train cell can have: a step
that leaves the state unchanged, a step over half of its batch (the mean
taken over the rest), a step that leaves one leaf unmoved, and a step whose
loss is not finite. The sound run beside them comes out correct (on the CPU
the program and the reference sum in the same order)."""

from __future__ import annotations

import pytest
import torch
from conftest import small_cell

SEED = 2**31 + 101


def _run(bench, name: str) -> dict:
    from pn2bench import harness

    return harness.run_cell(small_cell(bench, name), SEED, 0.2, False, [torch.device("cpu")])


@pytest.mark.parametrize("name", ["ssg.train", "msg.train"])
def test_a_sound_run_is_correct(bench, name):
    res = _run(bench, name)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0, res["checks"]
    assert res["device"]["count"] == 1


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(bench, monkeypatch):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pointnet2_scannet_tpu_torch.engine.loss import weighted_cross_entropy

    def frozen(state, batch, *, num_classes, group=None, lr=None):
        with torch.no_grad():
            logits = state.model(batch["points"], state.generator)
            loss = weighted_cross_entropy(logits, batch["labels"], batch["weights"], batch.get("row_mask"))
        state.step += 1
        return {"loss": loss, "confusion": torch.zeros(num_classes, num_classes, dtype=torch.int64)}

    monkeypatch.setattr(ts, "train_step", frozen)
    res = _run(bench, "ssg.train")
    assert res["correct"] is False and res["checks"]["update_gap"]["value"] > 0.9  # every leaf unmoved


def test_a_step_over_half_the_batch_is_not_correct(bench, monkeypatch):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    whole = ts.train_step

    def half(state, batch, **kw):
        return whole(state, {k: v[: len(v) // 2] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(ts, "train_step", half)
    res = _run(bench, "ssg.train")
    assert res["correct"] is False, res["checks"]


def test_a_step_that_leaves_one_leaf_unmoved_is_not_correct(bench, monkeypatch):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts
    from pn2bench.drivers import train

    whole = ts.train_step

    def one_leaf(state, batch, **kw):
        leaf = dict(state.model.named_parameters())[train.FROZEN_LEAF]
        before = leaf.detach().clone()
        out = whole(state, batch, **kw)
        with torch.no_grad():
            leaf.copy_(before)
        return out

    monkeypatch.setattr(ts, "train_step", one_leaf)
    res = _run(bench, "ssg.train")
    checks = res["checks"]
    assert res["correct"] is False and checks["worst_update_gap"]["value"] > checks["worst_update_gap"]["limit"]


def test_a_step_with_a_loss_that_is_not_finite_is_not_correct(bench, monkeypatch):
    from pointnet2_scannet_tpu_torch.engine import train_state as ts

    whole = ts.train_step
    calls = []

    def poisoned(state, batch, **kw):
        out = whole(state, batch, **kw)
        calls.append(1)
        if len(calls) > 2:  # past the first call, which the reference follows
            out = {**out, "loss": out["loss"] * float("nan")}
        return out

    monkeypatch.setattr(ts, "train_step", poisoned)
    res = _run(bench, "ssg.train")
    assert res["failed"] > 0 and res["correct"] is False
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())  # the checks alone pass
