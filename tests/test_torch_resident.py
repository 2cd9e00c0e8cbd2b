"""The port's device-resident scene store (data/resident.py, the resident
mode of data/chunks.py, engine/train_state.resident_train_step, the
Solver's device_store and train_torch.py --device_store) against the JAX
package's, and against the port's own host path, on the CPU.

Both packages are numpy up to the batch, so the store, the chunk rows, the
offsets, the augmentation parameters and the batches of the two
ResidentBatchLoaders are equal bit for bit. materialize_batch is a row
gather and a table lookup: bit for bit with augmentation off; with it on,
the transform runs in float32 in both packages with sums in another order,
held to 1e-5 absolute on coordinates of a few metres (tens of float32 ulps).
The port's resident batches equal its host batches with augmentation off
and agree to 5e-5 with it on (the host rotates in float64 numpy; the JAX
package's own test holds the same bound). One resident train step is held
to the JAX resident step on transferred weights at the 1e-4 of
tests/test_torch_train_step.py (Dropout off), and a Solver with device_store
to the host-path Solver step for step.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu import config as jconfig
from pointnet2_scannet_tpu.data import chunks as jchunks
from pointnet2_scannet_tpu.data import resident as jresident
from pointnet2_scannet_tpu.data import synthetic as jsynth
from pointnet2_scannet_tpu.engine import train_state as jts
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu.parallel.mesh import make_mesh
from pointnet2_scannet_tpu.parallel.step import make_resident_train_step
from pointnet2_scannet_tpu_torch import config
from pointnet2_scannet_tpu_torch.data import chunks, resident, synthetic
from pointnet2_scannet_tpu_torch.data.pipeline import BatchLoader
from pointnet2_scannet_tpu_torch.data.wholescene import WholeSceneDataset
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.engine.solver import Solver, WholeSceneSolver
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from tests.test_torch_port_model import SMALL, _randomize_bn

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = dict(npoints=256, use_color=True, use_normal=True)
SPEC = dict(SMALL, input_channels=6, num_classes=20)
AUGMENT_ATOL = 1e-5  # materialize_batch, the port against the JAX package
HOST_ATOL = 5e-5  # resident against host coordinates (float32 vs float64 rotation)


@pytest.fixture(scope="module")
def stores():
    kw = dict(n_points=4000)
    return jsynth.make_synthetic_store(5, seed=0, **kw), synthetic.make_synthetic_store(5, seed=0, **kw)


def _cfgs(augment):
    return jconfig.DataConfig(**DATA, augment=augment), config.DataConfig(**DATA, augment=augment)


def _datasets(stores, augment, seed=3):
    """(JAX, port) resident-mode train datasets with their first chunks."""
    (jst, pst), (jcfg, pcfg) = stores, _cfgs(augment)
    jds = jchunks.ChunkedSceneDataset(jst, jcfg, phase="train", seed=seed, resident=True)
    pds = chunks.ChunkedSceneDataset(pst, pcfg, phase="train", seed=seed, resident=True)
    jds.generate_chunks()
    pds.generate_chunks()
    return jds, pds


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


def _torch_store(pst, pcfg):
    pts, labels = resident.flatten_store(pst, pcfg)
    return {"points": torch.from_numpy(pts), "labels": torch.from_numpy(labels),
            "wtable": torch.from_numpy(pst.label_weights.astype(np.float32))}


def _jax_store(jst, jcfg):
    pts, labels = jresident.flatten_store(jst, jcfg)
    return {"points": pts, "labels": labels, "wtable": jst.label_weights.astype(np.float32)}


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("fn", ["store_nbytes", "flatten_store", "pad_store_rows"])
def test_store_functions_equal_the_jax_package(stores, fn):
    (jst, pst), (jcfg, pcfg) = stores, _cfgs(True)
    if fn == "store_nbytes":
        assert resident.store_nbytes(pst, pcfg) == jresident.store_nbytes(jst, jcfg) == 5 * 4000 * 40
        return
    got, want = resident.flatten_store(pst, pcfg), jresident.flatten_store(jst, jcfg)
    if fn == "pad_store_rows":
        for shards in (1, 3, 7, 20000):
            got_p, want_p = resident.pad_store_rows(*got, shards), jresident.pad_store_rows(*want, shards)
            assert got_p[0].shape[0] % shards == 0
            _assert_same(dict(enumerate(got_p)), dict(enumerate(want_p)))
        return
    assert got[0].shape == (20000, 9) and got[1].shape == (20000,)
    _assert_same(dict(enumerate(got)), dict(enumerate(want)))


def test_flatten_store_refuses_2_31_rows():
    class Rows:  # a scene that only has a length: the check comes before any copy
        def __len__(self):
            return 2**30

    store = types.SimpleNamespace(scene_ids=["a", "b"], scenes={"a": Rows(), "b": Rows()}, multiview={})
    for flatten, cfg in ((resident.flatten_store, config.DataConfig(**DATA)),
                         (jresident.flatten_store, jconfig.DataConfig(**DATA))):
        with pytest.raises(ValueError, match="2147483648 rows >= 2\\^31"):
            flatten(store, cfg)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_resident_rows_offsets_and_items_equal_the_jax_package(stores, augment):
    jds, pds = _datasets(stores, augment, seed=7)
    assert pds.scene_offsets() == jds.scene_offsets() == {
        sid: 4000 * i for i, sid in enumerate(pds.store.scene_ids)}
    assert pds.augmenting == jds.augmenting == augment
    for epoch in range(3):
        if epoch:  # epoch 1 from the background regeneration, 2 in the foreground
            for ds in (jds, pds):
                ds.generate_chunks()
                if epoch == 1:
                    ds.start_regen_async()
        assert list(pds.chunks) == list(jds.chunks)
        for sid, rows in jds.chunks.items():
            assert pds.chunks[sid].dtype == rows.dtype
            np.testing.assert_array_equal(pds.chunks[sid], rows)
        for i in range(len(jds)):
            got, want = pds.get_item_resident(i), jds.get_item_resident(i)
            _assert_same(dict(enumerate(got)), dict(enumerate(want)))
    with pytest.raises(RuntimeError, match="get_item_resident"):
        pds.get_item(0)


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_resident_batch_loader_equals_the_jax_package(stores, shuffle):
    jds, pds = _datasets(stores, True)
    jl = jresident.ResidentBatchLoader(jds, 2, shuffle=shuffle, seed=5)
    pl = resident.ResidentBatchLoader(pds, 2, shuffle=shuffle, seed=5)
    assert len(pl) == len(jl) == 2
    for _ in range(2):  # two epochs: the shuffle's stream goes on
        batches = list(zip(pl, jl, strict=True))
        assert len(batches) == 2
        for got, want in batches:
            assert set(got) == {"idx", "row_mask", "rot", "trans", "scale"}
            _assert_same(got, want)
    with pytest.raises(ValueError, match="resident-mode"):
        resident.ResidentBatchLoader(chunks.ChunkedSceneDataset(pds.store, pds.cfg), 2)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_materialize_batch_matches_the_jax_package(stores, augment):
    jds, pds = _datasets(stores, augment)
    jbatch = next(iter(jresident.ResidentBatchLoader(jds, 4)))
    pbatch = next(iter(resident.ResidentBatchLoader(pds, 4)))
    assert set(pbatch) == ({"idx", "row_mask", "rot", "trans", "scale"} if augment else {"idx", "row_mask"})
    want = jax.jit(jresident.materialize_batch)(_jax_store(jds.store, jds.cfg), jbatch)
    got = resident.materialize_batch(_torch_store(pds.store, pds.cfg), _to_torch(pbatch))
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    if augment:
        assert any(not np.allclose(r, np.eye(3)) for r in pbatch["rot"])
        np.testing.assert_allclose(got["points"][..., :3], want["points"][..., :3], rtol=0, atol=AUGMENT_ATOL)
        got["points"], want["points"] = got["points"][..., 3:], want["points"][..., 3:]
    _assert_same(got, want)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_resident_batches_equal_the_host_path(stores, augment):
    """The port's resident path against its host path from the same seed,
    over two epochs (the second from the background regeneration)."""
    _, pst = stores
    pcfg = _cfgs(augment)[1]
    host = chunks.ChunkedSceneDataset(pst, pcfg, phase="train", seed=11)
    res = chunks.ChunkedSceneDataset(pst, pcfg, phase="train", seed=11, resident=True)
    store = _torch_store(pst, pcfg)
    for epoch in range(2):
        for ds in (host, res):
            ds.generate_chunks()
            if epoch == 0:
                ds.start_regen_async()
        hb = BatchLoader(host, 2, seed=1, drop_last=True, shuffle=True)
        rb = resident.ResidentBatchLoader(res, 2, seed=1, shuffle=True)
        for want, got in zip(hb, rb, strict=True):
            got = {k: v.numpy() for k, v in resident.materialize_batch(store, _to_torch(got)).items()}
            if augment:
                np.testing.assert_allclose(got["points"][..., :3], want["points"][..., :3], rtol=0,
                                           atol=HOST_ATOL)
                got["points"], want["points"] = got["points"][..., 3:], want["points"][..., 3:]
            _assert_same(got, want)


def test_resident_train_step_matches_the_jax_resident_step(stores):
    jds, pds = _datasets(stores, False)
    jbatch = next(iter(jresident.ResidentBatchLoader(jds, 2)))
    pbatch = next(iter(resident.ResidentBatchLoader(pds, 2)))
    _assert_same(pbatch, jbatch)
    jspec, pspec = jmodel.PointNet2Spec(**SPEC, dropout=0.0), pointnet2.PointNet2Spec(**SPEC, dropout=0.0)
    jm = jmodel.PointNet2SemSeg(spec=jspec)
    x = jnp.zeros((2, DATA["npoints"], 9), jnp.float32)
    variables = _randomize_bn(jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(2), x), 2)

    model = pointnet2.PointNet2SemSeg(pspec)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in convert.state_dict_from_jax(variables, pspec).items()}, strict=True)
    state = ts.create_train_state(model, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=0)
    out = ts.resident_train_step(state, _torch_store(pds.store, pds.cfg), _to_torch(pbatch), num_classes=20)

    jstate = jts.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                   batch_stats=variables["batch_stats"],
                                   tx=jts.make_optimizer(jts.make_lr_schedule(1e-3, 100, 0.7, 1)))
    step = make_resident_train_step(make_mesh(1), num_classes=20, donate=False)
    jstate, jout = step(jstate, _jax_store(jds.store, jds.cfg), jbatch, jax.random.key(0))

    assert state.step == 1
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
    assert int(out["confusion"].sum()) == int(np.asarray(jout["confusion"]).sum()) == 2 * DATA["npoints"]
    want = convert.state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats}, pspec)
    buffers = dict(model.named_buffers())
    stats = [k for k, b in buffers.items() if b.is_floating_point()]
    assert stats
    for k in stats:
        np.testing.assert_allclose(buffers[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def _run_cfg(augment, device_store):
    return config.RunConfig(
        tag="resident", data=config.DataConfig(**DATA, augment=augment),
        train=config.TrainConfig(batch_size=4, epochs=2, verbose=0, seed=0, device_store=device_store),
    )


def _solver(store, tmp_path, augment, device_store, name):
    cfg = _run_cfg(augment, device_store)
    ds = chunks.ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**SPEC), generator=torch.Generator().manual_seed(0))
    return Solver(model, ds, None, cfg, tmp_path / name, device="cpu")


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_solver_with_device_store_trains_as_the_host_path(tmp_path, monkeypatch, capsys, augment):
    store = synthetic.make_synthetic_store(8, seed=0, n_points=4000)
    losses = {}
    step = ts.train_step

    def recorded(state, batch, **kw):  # resident_train_step calls it too
        out = step(state, batch, **kw)
        losses.setdefault(name, []).append(float(out["loss"]))
        return out

    monkeypatch.setattr(ts, "train_step", recorded)
    for name in ("host", "resident"):
        solver = _solver(store, tmp_path, augment, name == "resident", name)
        assert solver.device_store == (name == "resident")
        assert isinstance(solver.train_loader, resident.ResidentBatchLoader if solver.device_store else BatchLoader)
        solver()
    assert "device_store disabled" not in capsys.readouterr().out
    assert solver.store["points"].shape == (8 * 4000, 9) and solver.store_upload_s >= 0
    assert len(losses["host"]) == 4 and all(np.isfinite(losses["host"]))
    if augment:
        np.testing.assert_allclose(losses["resident"], losses["host"], rtol=5e-3)
    else:
        assert losses["resident"] == losses["host"]


@pytest.mark.parametrize("why", ["budget", "wholescene"])
def test_device_store_falls_back_with_a_warning(tmp_path, monkeypatch, capsys, why):
    store = synthetic.make_synthetic_store(4, seed=0, n_points=2000)
    model = pointnet2.PointNet2SemSeg(pointnet2.PointNet2Spec(**SPEC), generator=torch.Generator().manual_seed(0))
    cfg = _run_cfg(False, True)
    if why == "budget":
        monkeypatch.setenv("PN2_DEVICE_STORE_BUDGET_GB", "0")
        ds = chunks.ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
        solver = Solver(model, ds, None, cfg, tmp_path, device="cpu")
        reason = "flat store needs 0.00 GiB > budget 0.0 GiB (set PN2_DEVICE_STORE_BUDGET_GB to raise)"
    else:
        ds = WholeSceneDataset(store, cfg.data, seed=0)
        solver = WholeSceneSolver(model, ds, None, cfg, tmp_path, device="cpu")
        reason = "the train dataset has no resident mode (chunked training only)"
    out = capsys.readouterr().out
    assert re.findall(r"^WARNING: device_store disabled: (.*)$", out, re.M) == [reason]
    assert solver.device_store is False and solver.store is None
    assert not getattr(ds, "resident", False)
    if why == "budget":
        assert isinstance(solver.train_loader, BatchLoader)
        monkeypatch.delenv("PN2_DEVICE_STORE_BUDGET_GB")
        assert Solver(model, chunks.ChunkedSceneDataset(store, cfg.data, seed=0), None, cfg, tmp_path / "b",
                      device="cpu").device_store  # the CPU's default budget, 8 GiB, holds it
    solver()
    assert len(json.loads((tmp_path / "tensorboard" / "all_scalars.json").read_text())["train/loss"]) == 2


# --- train_torch.py --device_store

BASE = ["--device", "cpu", "--synthetic", "--synthetic_scenes", "4", "--npoints", "256",
        "--batch_size", "4", "--verbose", "1", "--use_color", "--use_normal"]


def _train(argv):
    spec = importlib.util.spec_from_file_location("train_torch", ROOT / "scripts" / "train_torch.py")
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run, _ = train_torch.train(train_torch.parse_args(argv))
    return run, out.getvalue()


@pytest.fixture(scope="module")
def store_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_torch_store")
    return _train([*BASE, "--epoch", "1", "--device_store", "--tag", "ds", "--output_root", str(root)])


@pytest.mark.parametrize("flag,stored", [(None, True), ("--no_device_store", False), ("--device_store", True)])
def test_train_torch_device_store_trains_and_resumes(store_run, tmp_path, flag, stored):
    run_dir, log = store_run
    assert "device_store disabled" not in log
    assert re.search(r"^device_store: 240000 rows x 9 on cpu", log, re.M)
    assert json.loads((run_dir / "config.json").read_text())["train"]["device_store"] is True
    loss = re.findall(r"^epoch \[1/1\] iter \[1/1\] loss (\S+)", log, re.M)
    assert len(loss) == 1 and np.isfinite(float(loss[0]))
    copy = tmp_path / run_dir.name
    shutil.copytree(run_dir, copy)
    if flag == "--device_store":  # a run saved without the store resumes with it
        cfg = json.loads((copy / "config.json").read_text())
        cfg["train"]["device_store"] = False
        (copy / "config.json").write_text(json.dumps(cfg))
    _, log = _train(["--device", "cpu", "--resume", str(copy), "--epoch", "2", *([flag] if flag else [])])
    assert "(from epoch 1)" in log and "device_store disabled" not in log
    assert bool(re.search(r"^device_store: ", log, re.M)) is stored
    assert json.loads((copy / "config.json").read_text())["train"]["device_store"] is stored
    assert re.findall(r"^epoch \[(\d)/2\] iter", log, re.M) == ["2"]


def test_train_torch_refuses_both_store_flags(tmp_path):
    with pytest.raises(SystemExit, match="conflict"):
        _train([*BASE, "--device_store", "--no_device_store", "--output_root", str(tmp_path)])
    assert not any(tmp_path.iterdir())
