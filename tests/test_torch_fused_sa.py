"""The fused gather-matmul (kernel k, scripts/bench_fused_sa.py:69) and its
bench script's port, on the CPU.

- The port's fused_gather_mm (on the CPU the plain version of
  fused_gather_mm.cu) against the JAX script's fused_gather_mm, its
  pl.pallas_call run in interpret mode: within 1e-6 of max |out|. Not bit
  for bit: the jitted interpret-mode kernel is compiled by XLA's CPU
  compiler, which contracts w * g + o into an fma (measured up to 1.8e-7
  absolute from a sequential float32 loop at these shapes).
- The plain version against that sequential float32 loop (numpy, c
  ascending from 0, each product and sum rounded): bit for bit, which is
  the order the CUDA kernel keeps.
- The op's domain (N and J multiples of 128, no gradient), and
  scripts/bench_fused_sa_torch.py on the CPU passing its own check.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.ops.cuda import fused_gather_mm_kernel as fk

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX script's fused_gather_mm with every pl.pallas_call in
    interpret mode (a fresh module: no trace cached without the patch)."""
    mod = _load("bench_fused_sa")
    orig = mod.pl.pallas_call
    monkeypatch.setattr(mod.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return mod.fused_gather_mm


def _inputs(b, n, j, c, f, seed):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, j)).astype(np.int32)
    w = rng.normal(size=(c, f)).astype(np.float32) * np.float32(0.1)
    return src, idx, w


SHAPES = [(2, 256, 256, 9, 32), (2, 256, 256, 32, 64)]


@pytest.mark.parametrize("b,n,j,c,f", SHAPES, ids=["c9-f32", "c32-f64"])
def test_plain_fused_gather_mm_matches_the_interpret_mode_jax_kernel(jax_fused, b, n, j, c, f):
    src, idx, w = _inputs(b, n, j, c, f, seed=c)
    got = ops.fused_gather_mm(torch.from_numpy(src), torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_fused(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(w)))
    assert got.shape == want.shape == (b, j, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,n,j,c,f", SHAPES + [(3, 100, 77, 5, 7)], ids=["c9-f32", "c32-f64", "ragged"])
def test_plain_fused_gather_mm_is_the_sequential_float32_loop(b, n, j, c, f):
    src, idx, w = _inputs(b, n, j, c, f, seed=f)
    g = np.take_along_axis(src, idx[..., None].astype(np.int64), axis=1)
    want = np.zeros((b, j, f), np.float32)
    for k in range(c):
        want = want + g[..., k : k + 1] * w[k]
    got = fk.fused_gather_mm_plain(torch.from_numpy(src), torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_gather_mm_refuses_outside_the_tpu_kernels_domain():
    src, idx, w = (torch.from_numpy(a) for a in _inputs(1, 256, 256, 9, 32, seed=0))
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.fused_gather_mm(src[:, :200], idx, w)  # N % 128 != 0
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.fused_gather_mm(src, idx[:, :100], w)  # J % 128 != 0
    with pytest.raises(ValueError, match=r"\(B, N, C\)"):
        ops.fused_gather_mm(src[0], idx, w)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.fused_gather_mm(src, idx, w.requires_grad_(True))
    with torch.no_grad():
        assert ops.fused_gather_mm(src, idx, w).shape == (1, 256, 32)


def test_bench_fused_sa_torch_passes_its_check_on_the_cpu():
    row = _load("bench_fused_sa_torch").run("cpu", reps=1)
    assert row["device"] == "cpu" and (row["B"], row["N"], row["J"]) == (2, 1024, 4096)
    assert row["fused rel err"] < 1e-5 and row["unfused rel err"] < 1e-5
    assert all(row[f"{k} ms"] > 0 for k in ("gather-only", "gather+matmul", "fused"))


# (B, N, J, C, F, SMs, plan): the fixed route at bench_fused_sa's shape on an
# H100 SXM (132 SMs) and PCIe (114), one wave of 3 blocks an SM; fewer blocks
# than that where there are fewer 128-row tiles (J 200: two a batch row, the
# second part-filled); past 65535 batch rows (one grid dimension's limit);
# the general route at other C and F and where a batch row's source passes
# 32-bit offsets
K_PLANS = [
    (32, 8192, 32768, 9, 32, 132, ("fixed", 396)), (32, 8192, 32768, 9, 32, 114, ("fixed", 342)),
    (3, 300, 200, 9, 32, 132, ("fixed", 6)), (65537, 3, 5, 9, 32, 132, ("fixed", 396)),
    (32, 8192, 32768, 32, 64, 132, ("general", 8448)), (3, 100, 77, 5, 7, 132, ("general", 2)),
    (1, 2**28, 128, 9, 32, 132, ("general", 4)),
]


@pytest.mark.parametrize("b,n,j,c,f,sms,want", K_PLANS)
def test_fused_gather_mm_plan(b, n, j, c, f, sms, want):
    p = fk.plan(b, n, j, c, f, sms)
    assert tuple(p) == want
    routes = fk.candidate_plans(b, n, j, c, f, sms)
    assert p in routes and routes[-1].route == "general"
    assert {q.route for q in routes} == (set(fk.ROUTES) if p.route == "fixed" else {"general"})
    assert all(q.blocks >= 1 for q in routes)
