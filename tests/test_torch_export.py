"""The port's serving artifacts on the CPU: the pn2:: ops (ops/library.py),
engine/export.py's export_forward / save_exported / load_exported /
ServingPredictor, and scripts/infer_torch.py --export / --from_artifact.

Weights come from the JAX tiny models (SSG and MSG, 9 input channels, 20
classes, BatchNorm statistics drawn from a seed), carried over with
models/convert.state_dict_from_jax; inputs are 2- to 5-column stacks of
512 points drawn with numpy. Each model is exported once (module fixture).

- Each op's output equals its plain version's bit for bit, and its fake
  impl gives the real output's shape and dtype.
- The SSG program holds the pn2:: ops of the CPU's routes and fewer than
  2,000 graph nodes (tracing through the plain FPS loop unrolled it into
  26,679).
- A saved and loaded artifact serves labels equal to the port's Predictor
  bit for bit (SSG and MSG in float32, SSG in bfloat16), a ragged stack of 5
  on a batch of 2 included; its float32 logits are within 1e-4 of the JAX
  package's own artifact (jax.export) served by its ServingPredictor.
- emit is validated; an empty stack gives the contract shape; the
  platforms round-trip and a CPU-only artifact refuses the card; serving
  round-robin over two (CPU) devices equals one device.
- The CLI: --export, then --from_artifact --synthetic, and the run dir
  served over two devices (through an artifact exported in-process) write
  the prediction and PLY files that serving the run dir writes.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pointnet2_scannet_tpu.engine import export as jexport
from pointnet2_scannet_tpu.models import pointnet2 as jmodel
from pointnet2_scannet_tpu_torch.config import DataConfig, ModelConfig, RunConfig
from pointnet2_scannet_tpu_torch.engine import export
from pointnet2_scannet_tpu_torch.engine.checkpoint import save_state_dict
from pointnet2_scannet_tpu_torch.models import convert, pointnet2
from pointnet2_scannet_tpu_torch.ops import library
from pointnet2_scannet_tpu_torch.ops.cuda import (
    ball_query_kernel as bq,
    ball_query_multi_kernel as bqm,
    fps_kernel as fps,
    gather_kernel as ga,
    gather_smem_kernel as gs,
    three_nn_kernel as nn3,
    three_nn_q_kernel as nnq,
)
from tests.test_torch_port_model import _randomize_bn

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, C = 512, 9
RTOL = ATOL = 1e-4  # float32 logits against JAX: matmul summation order
MODELS = {"ssg": (False, None), "msg": (True, None), "ssg_bf16": (False, torch.bfloat16)}
# the artifacts' platforms: SSG's may also run on the card
PLATFORMS = {"ssg": ["cpu", "cuda"], "msg": ["cpu"], "ssg_bf16": ["cpu"]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small shapes gain little from more, which
    would only contend with the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(s, seed):
    return np.random.default_rng(seed).uniform(0, 1.5, (s, N, C)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_models():
    """(JAX model, its variables) of the tiny SSG and MSG models."""
    out = {}
    for is_msg in (False, True):
        model = jmodel.get_model(20, is_msg=is_msg, input_channels=6)
        x = jnp.zeros((1, N, C), jnp.float32)
        variables = jax.jit(lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(5))
        out[is_msg] = model, _randomize_bn(variables, 5 + is_msg)
    return out


def _port_model(jax_models, name):
    is_msg, dtype = MODELS[name]
    model = pointnet2.get_model(20, is_msg=is_msg, input_channels=6, dtype=dtype)
    state = convert.state_dict_from_jax(jax_models[is_msg][1], model.spec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def artifacts(jax_models, tmp_path_factory):
    """name -> (port model, the Exported, the artifact loaded back)."""
    tmp = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name in MODELS:
        model = _port_model(jax_models, name)
        exported = export.export_forward(model, batch_size=2, npoints=N, channels=C,
                                         platforms=PLATFORMS[name])
        out[name] = model, exported, export.load_exported(export.save_exported(exported, tmp / f"{name}.pt2"))
    return out


# ------------------------------------------------------------------ the ops


def _op_cases():
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((2, N, 3), generator=g) * 1.5
    q = xyz[:, :128].contiguous()
    idx = torch.randint(0, N, (2, 256), generator=g, dtype=torch.int32)
    feats = torch.randn((2, N, 12), generator=g)
    words = torch.randint(-2**31, 2**31 - 1, (2, N, 3), generator=g, dtype=torch.int32)
    return {
        "a": (library.furthest_point_sample, (xyz, 128, True),
              lambda: fps.furthest_point_sample_plain(xyz, 128)),
        "b": (library.ball_query, (0.2, 32, xyz, q), lambda: bq.ball_query_plain(0.2, 32, xyz, q)),
        "c": (library.ball_query_multi, ([0.1, 0.2], [16, 32], xyz, q),
              lambda: bqm.ball_query_multi_plain((0.1, 0.2), (16, 32), xyz, q)),
        "d_f32": (library.gather, (feats, idx), lambda: ga.gather_plain(feats, idx)),
        "d_i32": (library.gather, (words, idx), lambda: ga.gather_plain(words, idx)),
        "d_bf16": (library.gather, (feats.bfloat16(), idx), lambda: ga.gather_plain(feats.bfloat16(), idx)),
        "e_f32": (library.gather_smem, (feats, idx), lambda: gs.gather_smem_plain(feats, idx)),
        "e_bf16": (library.gather_smem, (feats.bfloat16(), idx),
                   lambda: gs.gather_smem_plain(feats.bfloat16(), idx)),
        "i": (library.three_nn, (xyz, q), lambda: nn3.three_nn_plain(xyz, q)),
        "j": (library.three_nn_q, (xyz, q), lambda: nnq.three_nn_q_plain(xyz, q)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_op_equals_its_plain_version_and_its_fake_the_real_shape(case):
    op, args, plain = _op_cases()[case]
    got, want = op(*args), plain()
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == [(g.shape, g.dtype) for g in got]


# ------------------------------------------------------------------ the artifacts


def test_ssg_graph_holds_its_route_ops_in_under_2000_nodes(artifacts):
    _, exported, loaded = artifacts["ssg"]
    ops = [str(n.target) for n in exported.program.graph.nodes if str(n.target).startswith("pn2.")]
    counts = {op: ops.count(op) for op in set(ops)}
    # the CPU's routes: every gather "xla" (d), every 3-NN three_nn (i)
    assert counts == {"pn2.furthest_point_sample.default": 4, "pn2.ball_query.default": 4,
                      "pn2.gather.default": 12, "pn2.three_nn.default": 4}
    assert exported.num_nodes < 2000 and loaded.num_nodes == exported.num_nodes
    assert loaded.in_shape == (2, N, C) and loaded.out_meta == ((2, N), torch.int8)


@pytest.mark.parametrize("name", list(MODELS))
def test_artifact_labels_equal_the_predictor(artifacts, name):
    model, _, loaded = artifacts[name]
    x = _points(5, 11)  # ragged: two full batches of 2 and one padded
    serving = export.ServingPredictor(loaded, devices=["cpu"])
    assert (serving.batch_size, serving.npoints, serving.channels) == (2, N, C)
    got = serving.predict(x)
    want = export.Predictor(model, batch_size=2, npoints=N, channels=C, device="cpu").predict(x)
    assert got.shape == (5, N) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="expected"):
        serving.predict(x[..., :6])


@pytest.fixture(scope="module")
def logits_artifacts(jax_models, tmp_path_factory):
    """The SSG logits artifact of the port and of the JAX package, each
    saved and loaded back."""
    tmp = tmp_path_factory.mktemp("logits")
    port = export.export_forward(_port_model(jax_models, "ssg"), batch_size=2, npoints=N, channels=C,
                                 emit="logits", platforms=["cpu"])
    port = export.load_exported(export.save_exported(port, tmp / "ssg_logits.pt2"))
    model, variables = jax_models[False]
    jx = jexport.export_forward(model.apply, variables, batch_size=2, npoints=N, channels=C,
                                emit="logits", platforms=["cpu"])
    jx = jexport.load_exported(jexport.save_exported(jx, tmp / "ssg_logits.jexp"))
    return port, jx


def test_f32_logits_match_the_jax_artifact(logits_artifacts):
    port, jx = logits_artifacts
    x = _points(3, 12)
    got = export.ServingPredictor(port, devices=["cpu"]).predict(x)
    want = jexport.ServingPredictor(jx).predict(x)
    assert got.shape == want.shape == (3, N, 20) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_emit_is_validated_and_an_empty_stack_gives_the_contract_shape(artifacts, logits_artifacts):
    model = artifacts["ssg"][0]
    with pytest.raises(ValueError, match="emit"):
        export.export_forward(model, batch_size=1, npoints=N, channels=C, emit="probs", platforms=["cpu"])
    empty = np.zeros((0, N, C), np.float32)
    labels = export.ServingPredictor(artifacts["ssg"][2], devices=["cpu"]).predict(empty)
    assert labels.shape == (0, N) and labels.dtype == np.int8
    logits = export.ServingPredictor(logits_artifacts[0], devices=["cpu"]).predict(empty)
    assert logits.shape == (0, N, 20) and logits.dtype == np.float32


def test_platforms_round_trip_and_a_cpu_artifact_refuses_the_card(artifacts):
    for name, (_, exported, loaded) in artifacts.items():
        assert loaded.platforms == exported.platforms == tuple(PLATFORMS[name])
        assert loaded.device == exported.device == "cpu"
        assert loaded.ops_config == exported.ops_config
    with pytest.raises(ValueError, match=r"platforms \['cpu'\]; cannot serve on \['cuda'\]"):
        export.ServingPredictor(artifacts["msg"][2], devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="platforms must be among"):
        export.export_forward(artifacts["msg"][0], batch_size=1, npoints=N, channels=C, platforms=["tpu"])


def test_round_robin_over_two_devices_equals_one(artifacts):
    loaded = artifacts["ssg"][2]
    x = _points(7, 13)  # four batches over two devices, a ragged tail
    one = export.ServingPredictor(loaded, devices=["cpu"]).predict(x)
    two = export.ServingPredictor(loaded, devices=["cpu", "cpu"])
    assert [str(d) for d in two.devices] == ["cpu", "cpu"]
    np.testing.assert_array_equal(two.predict(x), one)


# ------------------------------------------------------------------ the CLI


def _infer_torch():
    spec = importlib.util.spec_from_file_location("infer_torch", ROOT / "scripts" / "infer_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_serves_an_artifact_as_it_serves_the_run_dir(jax_models, tmp_path, capsys):
    run = tmp_path / "run"
    run.mkdir()
    RunConfig(tag="export", data=DataConfig(npoints=N, use_color=True, use_normal=True),
              model=ModelConfig(is_msg=False)).save(run / "config.json")
    save_state_dict(run, "model_best", _port_model(jax_models, "ssg").state_dict())
    cli = _infer_torch()
    common = ["--folder", str(run), "--device", "cpu"]
    serve = [*common, "--synthetic", "--write_ply"]
    cli.infer(cli.parse_args([*serve, "--batch_size", "16", "--out", str(tmp_path / "run_dir")]))
    stats = cli.infer(cli.parse_args([*common, "--export", str(tmp_path / "m.pt2"), "--batch_size", "16"]))
    assert stats["input"] == (16, N, C) and stats["platforms"] == ["cpu"] and stats["nodes"] < 2000
    assert "graph nodes" in capsys.readouterr().out
    cli.infer(cli.parse_args([*serve, "--from_artifact", str(tmp_path / "m.pt2"), "--num_devices", "2",
                              "--out", str(tmp_path / "artifact")]))
    # the run dir over two devices: through an artifact exported in-process
    cli.infer(cli.parse_args([*serve, "--batch_size", "16", "--num_devices", "2", "--out", str(tmp_path / "two")]))
    want = sorted(p.name for p in (tmp_path / "run_dir").iterdir())
    assert want == ["synth0000_00_pred.npy", "synth0000_00_pred.ply"]
    for out in ("artifact", "two"):
        assert sorted(p.name for p in (tmp_path / out).iterdir()) == want
        for name in want:
            assert (tmp_path / out / name).read_bytes() == (tmp_path / "run_dir" / name).read_bytes()
    more = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"--num_devices {more} but only"):
        cli.infer(cli.parse_args([*serve[:2], "--device", "cuda", "--num_devices", str(more),
                                  "--from_artifact", str(tmp_path / "m.pt2")]))
