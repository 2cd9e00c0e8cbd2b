"""Kernels e, f and g on bfloat16 rows against the JAX package on the CPU.

The JAX package runs its one-hot MXU gathers on bfloat16 rows whenever
mxu_gather is on (the MXU-gather configuration, P1: vmem_gather off,
mxu_gather on) and its model computes in bfloat16. The port's plain
versions (what the CUDA kernels compute, held bit for bit against them on
the card) against the Pallas kernels in interpret mode, inputs drawn from
numpy seeds:

- e: the port's mxu_gather forward against _mxu_gather_fwd_only, bit for
  bit on finite values without -0.0 (the one-hot product gives +0.0), at
  odd and even C.
- f: its backward on bfloat16 cotangents against _mxu_gather_bwd, bit for
  bit, at J = 128, at J spanning many tiles and at a row named in every
  tile: per 128-index tile a float32 sum in ascending j, rounded to
  bfloat16 and added to a bfloat16 accumulator. The single-rounding sum
  (h's bfloat16 contract) agrees with the JAX kernel at only about half
  the elements of a skewed shape, so the test tells the two orders apart.
- g: mxu_gather_split on bfloat16 rows and its VJP (h: a float32 sum
  rounded once) against the JAX split kernels, bit for bit.
- The slice: a small SSG bfloat16 model under P1 (logits, one train step's
  loss and gradients) against the JAX bfloat16 model under the same
  switches, weights moved by models/convert.py, within
  tests/test_torch_bf16_model.py's bounds, both sides taking the MXU route
  at the same gathers.
- The wrappers on a stand-in card: e sends bfloat16 rows as int32 lane
  pairs (even C) or 2-byte words (odd C), f passes 2-byte elements and
  refuses J % 128 != 0, the bfloat16 launch counters move, and the float32
  plans stay as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.ops.pallas import gather_kernel as jgk
from pointnet2_scannet_tpu_torch.engine import train_state as ts
from pointnet2_scannet_tpu_torch.ops import cuda as kernels
from pointnet2_scannet_tpu_torch.ops import mxu_gather as pmg
from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.cuda import gather_smem_kernel as gs
from pointnet2_scannet_tpu_torch.ops.cuda import gather_split_kernel as gsp
from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
from pointnet2_scannet_tpu_torch.ops.cuda import scatter_smem_kernel as ss
from tests.test_torch_bf16_model import (
    GRAD_VS_JAX_ALL,
    GRAD_VS_JAX_WORST,
    LABEL_AGREE,
    LOGIT_SCALE_TOL,
    STEP_LOSS_RTOL,
    _jax_step_grads,
    _models,
    _port_step_grads,
    _rel_l2,
    _rel_l2_all,
)
from tests.test_torch_mxu_port import SLICE, _counting, _interpret, _switch
from tests.test_torch_port_ops import fake_card  # noqa: F401  (a fixture)

BF16 = torch.bfloat16
P1 = {"vmem_gather": False, "mxu_gather": True}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small shapes gain nothing from more, which
    would only contend with the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 torch tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _bf16(x: np.ndarray):
    """The same float32 numbers rounded to bfloat16 in both frameworks."""
    return torch.from_numpy(x).to(BF16), jnp.asarray(x).astype(jnp.bfloat16)


def _values(rng, shape) -> np.ndarray:
    """Finite float32 values over many binades, both signs, +0.0 and no -0.0."""
    x = rng.normal(0, 1, shape) * 10.0 ** rng.uniform(-3, 3, shape)
    x.reshape(-1)[::13] = 0.0
    return x.astype(np.float32)


# ------------------------------------------------------------------- e


@pytest.mark.parametrize("b,n,j,c", [(2, 256, 384, 9), (2, 256, 384, 12), (2, 1024, 2048, 70),
                                     (1, 128, 128, 1), (2, 256, 1024, 131)])
def test_e_bf16_gather_matches_jax_interpret(monkeypatch, b, n, j, c):
    _interpret(monkeypatch)
    rng = np.random.default_rng(n + j + c)
    t_src, j_src = _bf16(_values(rng, (b, n, c)))
    idx = rng.integers(0, n, (b, j)).astype(np.int32)
    got = pmg.mxu_gather(t_src, torch.from_numpy(idx))
    want = jgk._mxu_gather_fwd_only(j_src, jnp.asarray(idx))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------------------------- f


def _f_inputs(seed, b, n, j, c, skew=None):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (b, j)).astype(np.int32)
    if skew is not None:  # row `skew` of batch row 0 named by every third index
        idx[0, ::3] = skew
    t_g, j_g = _bf16(rng.normal(0, 1, (b, j, c)).astype(np.float32))
    return idx, t_g, j_g


# (B, N, J, C, skewed row): one tile; many tiles at odd and even C; a row
# named in every tile (about 43 terms a tile); MSG's SA2-like width
F_SHAPES = [(2, 256, 128, 8, None), (2, 128, 128, 9, None), (2, 256, 4096, 67, None),
            (1, 1024, 8192, 12, None), (2, 128, 1024, 131, 7), (2, 256, 2048, 8, 5)]


@pytest.mark.parametrize("b,n,j,c,skew", F_SHAPES)
def test_f_bf16_backward_matches_jax_interpret(monkeypatch, b, n, j, c, skew):
    _interpret(monkeypatch)
    idx, t_g, j_g = _f_inputs(n + j + c, b, n, j, c, skew)
    want = jgk._mxu_gather_bwd(jnp.asarray(idx), j_g, n=n)
    got = ss.scatter_smem_plain(torch.from_numpy(idx), t_g, n)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # through the autograd wiring of mxu_gather, as the model takes it
    x = torch.zeros((b, n, c), dtype=BF16, requires_grad=True)
    pmg.mxu_gather(x, torch.from_numpy(idx)).backward(t_g)
    np.testing.assert_array_equal(_bits(x.grad), _bits(want))


def test_single_rounding_is_told_apart_from_the_jax_tile_order(monkeypatch):
    # B 2, N 256, J 2048, C 8, every third index of batch row 0 naming row
    # 5: the float32 sum rounded once (scatter_kernel's bfloat16 contract)
    # differs from the JAX kernel at many elements, the tile order at none
    _interpret(monkeypatch)
    idx, t_g, j_g = _f_inputs(0, 2, 256, 2048, 8, skew=5)
    want = _bits(jgk._mxu_gather_bwd(jnp.asarray(idx), j_g, n=256))
    once = _bits(sc.scatter_add_plain(torch.from_numpy(idx), t_g, 256))
    tiled = _bits(ss.scatter_smem_plain(torch.from_numpy(idx), t_g, 256))
    assert np.array_equal(tiled, want)
    assert np.mean(once == want) < 0.8
    assert not np.array_equal(once[0, 5], want[0, 5])


def test_f_bf16_plain_refuses_a_ragged_tile():
    with pytest.raises(ValueError, match="J % 128 == 0"):
        ss.scatter_smem_plain(torch.zeros((1, 200), dtype=torch.int32), torch.zeros((1, 200, 3), dtype=BF16), 8)


def test_f_float32_plain_is_unchanged():
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 64, (2, 300)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(2, 300, 5)).astype(np.float32))
    assert torch.equal(ss.scatter_smem_plain(idx, g, 64), sc.scatter_add_plain(idx, g, 64))


# ------------------------------------------------------------------- g


@pytest.mark.parametrize("c", [9, 32])
def test_g_bf16_split_gather_and_vjp_match_jax_interpret(monkeypatch, c):
    _interpret(monkeypatch)
    rng = np.random.default_rng(31 + c)
    t_src, j_src = _bf16(_values(rng, (2, 256, c)))
    idx = rng.integers(0, 256, (2, 1024)).astype(np.int32)
    t_g, j_g = _bf16(rng.normal(0, 1, (2, 1024, c)).astype(np.float32))
    x = t_src.clone().requires_grad_(True)
    got = pmg.mxu_gather_split(x, torch.from_numpy(idx))
    got.backward(t_g)
    want, vjp = jax.vjp(lambda s: jgk.mxu_gather_split(s, jnp.asarray(idx)), j_src)
    (want_grad,) = vjp(j_g)
    assert got.dtype == x.grad.dtype == BF16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(x.grad), _bits(want_grad))


# ------------------------------------------------------------- the slice


def _mxu_routes(monkeypatch):
    """Count the JAX package's mxu_gather calls, and reset the port's."""
    tuning.reset_route_counts()
    return _counting(monkeypatch, jgk, "mxu_gather")


def test_slice_p1_ssg_bf16_logits_match_jax(monkeypatch):
    _switch(monkeypatch, **P1)
    _interpret(monkeypatch)
    jm, variables, pm, pc = _models(SLICE, 2, 512, 41)
    with _mxu_routes(monkeypatch) as jax_calls:
        want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(pc)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= LOGIT_SCALE_TOL * np.abs(want).max()
    gl, wl = got.argmax(-1), want.argmax(-1)
    tie = (np.take_along_axis(want, gl[..., None], -1)[..., 0] == want.max(-1)) | \
          (np.take_along_axis(got, wl[..., None], -1)[..., 0] == got.max(-1))
    assert np.mean((gl == wl) | tie) >= LABEL_AGREE
    # SA1's centroids (float32 xyz) and packed grouping, SA2's packed
    # grouping: MXU on both sides; SA2's centroids (J = 32): not
    assert len(jax_calls) == 3
    assert tuning.route_counts[("gather", "mxu")] == 3 and tuning.route_counts[("gather", "xla")] == 1


def test_slice_p1_ssg_bf16_train_step_matches_jax(monkeypatch):
    from pointnet2_scannet_tpu_torch.models import convert, pointnet2

    _switch(monkeypatch, **P1)
    _interpret(monkeypatch)
    jm, variables, pm, pc = _models(SLICE, 2, 512, 42)
    rng = np.random.default_rng(43)
    labels = rng.integers(0, SLICE["num_classes"], (2, 512)).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, (2, 512)).astype(np.float32)
    pspec = pointnet2.PointNet2Spec(**SLICE)

    with _mxu_routes(monkeypatch) as jax_calls:
        j_loss, j_grads = _jax_step_grads(jm, variables, pc, labels, weights)
    assert len(jax_calls) == 3
    j_grads = {k: np.asarray(v, np.float64) for k, v in convert.state_dict_from_jax(
        {"params": j_grads, "batch_stats": variables["batch_stats"]}, pspec).items()
        if not k.split(".")[-1].startswith(("running", "num_batches"))}
    tuning.reset_route_counts()
    p_loss, p_grads = _port_step_grads(pm, pc, labels, weights)
    assert tuning.route_counts[("gather", "mxu")] == 3
    ref = pointnet2.PointNet2SemSeg(pspec)
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(variables, pspec).items()})
    _, r_grads = _port_step_grads(ref.to(torch.float64), pc, labels, weights, torch.float64)

    assert set(p_grads) == set(j_grads) == set(r_grads)
    assert abs(p_loss - j_loss) <= STEP_LOSS_RTOL * abs(j_loss)
    jax_all = _rel_l2_all(j_grads, r_grads)
    assert _rel_l2_all(p_grads, r_grads) <= GRAD_VS_JAX_ALL * jax_all
    assert _rel_l2(p_grads, r_grads).max() <= GRAD_VS_JAX_WORST * _rel_l2(j_grads, r_grads).max()
    assert np.median(_rel_l2(p_grads, j_grads)) <= jax_all


def test_slice_p1_bf16_train_step_runs_e_and_f_plain_on_the_cpu(monkeypatch):
    # the MXU route's forward and backward on bfloat16 rows are e's and f's
    # plain versions on CPU tensors, and nothing is launched
    _switch(monkeypatch, **P1)
    kernels.reset_launch_counts()
    _, _, pm, pc = _models(SLICE, 2, 512, 44)
    seen = {"e": [], "f": []}
    e, f = gs.gather_smem_plain, ss.scatter_smem_plain
    monkeypatch.setattr(gs, "gather_smem_plain", lambda src, idx: seen["e"].append(src.dtype) or e(src, idx))
    monkeypatch.setattr(ss, "scatter_smem_plain", lambda idx, g, n: seen["f"].append(g.dtype) or f(idx, g, n))
    state = ts.create_train_state(pm, ts.make_lr_schedule(1e-3, 100, 0.7, 1), seed=0)
    out = ts.train_step(state, {"points": torch.from_numpy(pc), "labels": torch.zeros((2, 512), dtype=torch.int64),
                                "weights": torch.ones((2, 512))}, num_classes=SLICE["num_classes"])
    assert torch.isfinite(out["loss"])
    assert seen["e"].count(BF16) == 2 and seen["e"].count(torch.float32) == 1  # groupings; SA1 centroids
    assert seen["f"] == [BF16]  # SA2's grouping: SA1 groups input data
    assert sum(kernels.launch_counts().values()) == 0


# ------------------------------------------------ the wrappers on a stand-in card


def test_e_wrapper_sends_bf16_as_int32_pairs_or_2_byte_words(fake_card):
    idx = torch.zeros((2, 384), dtype=torch.int32)
    for c, (words, esize) in ((12, (6, 4)), (70, (35, 4)), (9, (9, 2)), (64, (32, 4))):
        out = gs.gather_smem_cuda(torch.zeros((2, 256, c), dtype=BF16), idx)
        assert out.dtype == BF16 and tuple(out.shape) == (2, 384, c)
        name, args = fake_card.calls[-1]
        p = gs.plan(2, 256, 384, words, 132, esize)
        assert name == "p2_gather_smem" and args[2:10] == (2, 256, 384, words, p.rows, p.width, p.blocks, esize)
    f32 = gs.gather_smem_cuda(torch.zeros((2, 256, 9)), idx)
    assert f32.dtype == torch.float32 and fake_card.calls[-1][1][5:10] == (9, *gs.plan(2, 256, 384, 9, 132)[:2],
                                                                           gs.plan(2, 256, 384, 9, 132).blocks, 4)
    gsp.gather_split_cuda(torch.zeros((2, 256, 9), dtype=BF16), idx)
    assert fake_card.calls[-1][1][9] == 2
    assert kernels.launch_counts()["gather_smem"] == 5 and kernels.launch_counts()["gather_split"] == 1
    assert kernels.bf16_launch_counts() == {"gather": 0, "scatter_add": 0, "gather_smem": 4, "scatter_smem": 0,
                                            "gather_split": 1}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gsp.gather_split_cuda(torch.zeros((2, 256, 9), dtype=torch.int32), idx)


def test_f_wrapper_passes_2_byte_elements_and_refuses_a_ragged_tile(fake_card):
    idx = torch.zeros((32, 8192), dtype=torch.int32)
    out = ss.scatter_smem_cuda(idx, torch.zeros((32, 8192, 70), dtype=BF16), 1024)
    assert out.dtype == BF16 and tuple(out.shape) == (32, 1024, 70)
    name, args = fake_card.calls[-1]
    p = ss.plan(32, 1024, 8192, 70, 132, 2)
    assert isinstance(p, ss.Plan)  # bfloat16 always sorts
    assert name == "p2_scatter_smem" and args[2:10] == (32, 1024, 8192, 70, p.tile, p.walkers, p.rows, 2)
    # float32 at the same shape keeps the accumulate route
    ss.scatter_smem_cuda(idx, torch.zeros((32, 8192, 70)), 1024)
    assert fake_card.calls[-1][0] == "p2_scatter_smem_accumulate"
    calls = len(fake_card.calls)
    with pytest.raises(ValueError, match="J % 128 == 0"):
        ss.scatter_smem_cuda(torch.zeros((2, 200), dtype=torch.int32), torch.zeros((2, 200, 8), dtype=BF16), 64)
    assert len(fake_card.calls) == calls
    assert kernels.launch_counts()["scatter_smem"] == 2
    assert kernels.bf16_launch_counts()["scatter_smem"] == 1


# (B, N, J, C): P1's float32 MXU-route gathers and backwards and
# bench_gather's shapes; their plans for 4-byte words are what the float32
# route took before bfloat16 rows came to e and f
F32_SHAPES = [(32, 8192, 1024, 3), (32, 8192, 32768, 9), (32, 1024, 256, 3), (32, 1024, 8192, 67),
              (32, 256, 2048, 131), (32, 8192, 32768, 32), (32, 8192, 32768, 64), (2, 64, 37, 9001)]


@pytest.mark.parametrize("sms", [114, 132])
def test_float32_plans_are_unchanged(sms):
    for b, n, j, c in F32_SHAPES:
        assert gs.plan(b, n, j, c, sms) == gs.plan(b, n, j, c, sms, 4)
        assert ss.plan(b, n, j, c, sms) == ss.plan(b, n, j, c, sms, 4)
        a = ss.accumulate_plan(b, n, c, sms)
        want = a if a.groups * -(-c // a.cs) * j <= ss.ACCUMULATE_WORK else ss.sort_plan(b, n, j, c, sms)
        assert ss.plan(b, n, j, c, sms) == want
    # the float32 tile of 4-byte words: rows a multiple of 4, width C, one
    # 16-byte-padded tile twice and the indices in shared memory
    p = gs.plan(32, 8192, 32768, 9, sms)
    assert p.rows % 4 == 0 and gs.shared_bytes(p) == 4 * (2 * (-(-p.rows * 9 // 4) * 4) + 2 * p.rows)


@pytest.mark.parametrize("sms", [114, 132])
def test_bf16_2_byte_plans_fit_shared_memory(sms):
    for b in (1, 2, 32):
        for n in (1, 60, 1024, 8192, 65535):
            for j in (1, 37, 1000, 32768):
                for c in (1, 3, 9, 67, 131, 2049, 20001):
                    p = gs.plan(b, n, j, c, sms, 2)
                    if p.rows > 1 or p.width == c:
                        assert p.rows % 8 == 0 and p.width == c  # every tile starts 16-byte aligned
                    else:
                        assert p.width == gs.TILE_BYTES // 2 and p.tiles == b * j * -(-c // p.width)
                    assert p.tiles * max(p.rows, 1) >= b * j
                    assert 1 <= p.blocks <= min(p.tiles, gs.BLOCKS_PER_SM * sms)
                    assert gs.shared_bytes(p, 2) <= gs.SHARED_BYTES
                    q = ss.plan(b, n, j, c, sms, 2) if n <= ss.MAX_N else None
                    assert q is None or isinstance(q, ss.Plan)


def test_full_width_ssg_bf16_routes_under_p1(monkeypatch):
    # one 8192-point column through the full-width SSG bfloat16 model under
    # P1: SA1's and SA2's centroids (float32 xyz) and the packed SA1-SA3
    # groupings (6 + 6, 6 + 64, 6 + 128 bfloat16 words) take the MXU route;
    # SA3's and SA4's centroids (J = 64, 16) and SA4's grouping (N = 64)
    # the plain gather (d)
    from pointnet2_scannet_tpu_torch.models import PointNet2SemSeg, ssg_spec

    _switch(monkeypatch, **P1)
    model = PointNet2SemSeg(ssg_spec(20, 6), dtype=BF16, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    pc = np.concatenate([rng.uniform(0, 1.5, (1, 8192, 3)), rng.normal(0, 0.5, (1, 8192, 6))], -1)
    routed = []
    route = tuning.gather_route
    monkeypatch.setattr(tuning, "gather_route", lambda n, j, c, dtype, *a, **k: routed.append(
        (n, j, c, dtype)) or route(n, j, c, dtype, *a, **k))
    tuning.reset_route_counts()
    with torch.inference_mode():
        assert torch.isfinite(model(torch.from_numpy(pc.astype(np.float32)))).all()
    assert tuning.route_counts[("gather", "mxu")] == 5 and tuning.route_counts[("gather", "xla")] == 3
    mxu = [r for r in routed if tuning.mxu_supported(*r[:3])]
    assert mxu == [(8192, 1024, 3, torch.float32), (8192, 32768, 12, BF16), (1024, 256, 3, torch.float32),
                   (1024, 8192, 70, BF16), (256, 2048, 134, BF16)]
