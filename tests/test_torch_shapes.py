"""The port's data/shapes.py and engine/metrics.instance_part_miou against
the JAX package's on the CPU: the same np.random.Generator draws the same
arrays bit for bit (both batch kinds, augmented or not, every sampler and
its part ids), and the instance mIoU is equal, the absent-part-is-1 case
included."""

import numpy as np
import pytest

from pointnet2_scannet_tpu.data import shapes as jshapes
from pointnet2_scannet_tpu.engine import metrics as jmetrics
from pointnet2_scannet_tpu_torch.data import shapes
from pointnet2_scannet_tpu_torch.engine import metrics


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tables_equal_jax():
    assert shapes.SHAPE_CLASSES == jshapes.SHAPE_CLASSES
    assert shapes.SHAPE_PARTS == jshapes.SHAPE_PARTS
    for k in range(1, len(shapes.SHAPE_CLASSES) + 1):
        np.testing.assert_array_equal(shapes.part_offsets(k), jshapes.part_offsets(k))
        np.testing.assert_array_equal(shapes.part_sizes(k), jshapes.part_sizes(k))
        assert shapes.num_parts_total(k) == jshapes.num_parts_total(k)
    assert shapes.num_parts_total(8) == 17


@pytest.mark.parametrize("kind", list(shapes.SHAPE_CLASSES))
def test_clouds_and_part_ids_equal_jax(kind):
    for augment in (True, False):
        got = shapes.make_shape_cloud(kind, 300, np.random.default_rng(5), augment=augment, return_parts=True)
        want = jshapes.make_shape_cloud(kind, 300, np.random.default_rng(5), augment=augment, return_parts=True)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("augment", [True, False], ids=["augment", "plain"])
def test_batches_equal_jax(augment):
    for seed in (0, [3, 1], 10_000):
        _equal(shapes.sample_cls_batch(np.random.default_rng(seed), 6, 256, 8, augment=augment),
               jshapes.sample_cls_batch(np.random.default_rng(seed), 6, 256, 8, augment=augment))
        _equal(shapes.sample_partseg_batch(np.random.default_rng(seed), 5, 256, 4, augment=augment),
               jshapes.sample_partseg_batch(np.random.default_rng(seed), 5, 256, 4, augment=augment))
    for draw in (shapes.sample_cls_batch, shapes.sample_partseg_batch):
        with pytest.raises(ValueError):
            draw(np.random.default_rng(0), 2, 64, 9)


def test_instance_part_miou_equals_jax():
    cats = 4
    offsets, sizes = shapes.part_offsets(cats), shapes.part_sizes(cats)
    batch = shapes.sample_partseg_batch(np.random.default_rng(2), 6, 128, cats)
    labels, category = batch["labels"], batch["category"]
    rng = np.random.default_rng(3)
    cases = {
        "exact": labels,
        "random": rng.integers(0, shapes.num_parts_total(cats), labels.shape).astype(np.int32),
        # a part absent from both the labels and the predictions: IoU 1
        "one_part": np.broadcast_to(offsets[category][:, None], labels.shape).astype(np.int32),
        "outside_the_block": (labels + 2) % shapes.num_parts_total(cats),
    }
    for name, preds in cases.items():
        got = metrics.instance_part_miou(preds, labels, category, offsets, sizes)
        want = jmetrics.instance_part_miou(preds, labels, category, offsets, sizes)
        assert got == want, name
    # absent from both: a one-point cloud of a 3-part cylinder, part 0 right
    cyl = shapes.SHAPE_CLASSES.index("cylinder")
    lo = int(offsets[cyl])
    miou, per_cat = metrics.instance_part_miou(np.array([[lo]]), np.array([[lo]]), np.array([cyl]),
                                               offsets, sizes)
    assert miou == 1.0 and per_cat == {cyl: [1.0]}
    assert metrics.instance_part_miou(np.zeros((0, 4)), np.zeros((0, 4)), np.zeros(0), offsets, sizes) == (0.0, {})
